"""A stand-in for ``h5py`` where it is not installed.

The port's batch pipeline stores its pair counts as HDF5 (``.hdf``) files
through ``h5py.File``. On a machine without ``h5py``, :func:`ensure_h5py`
puts a module named ``h5py`` into ``sys.modules`` whose ``File`` keeps the
part of the interface the port uses (groups, datasets read with ``[()]``
or slices, strings as bytes, ``attrs``) and stores each file as a pickle at
the same path. The package's own code path is unchanged. The stand-in is
not part of the package: ``chip_smoke.py`` and
``scripts/torch_tomo_pipeline_proof.py`` install it (the proof in the
subprocess that runs the command line). Its files are not HDF5: the JAX
package cannot read them.
"""

from __future__ import annotations

import sys


class _H5Dataset:
    def __init__(self, value) -> None:
        self._value = value

    def __getitem__(self, key):
        if isinstance(self._value, bytes):
            if key != ():
                raise KeyError(key)
            return self._value
        return self._value[key]


class _H5Group:
    def __init__(self) -> None:
        self._items: dict = {}
        self.attrs: dict = {}

    def create_group(self, name: str) -> "_H5Group":
        self._items[name] = group = _H5Group()
        return group

    def create_dataset(self, name: str, data=None, **_compression) -> _H5Dataset:
        import numpy as np

        value = data.encode("utf-8") if isinstance(data, str) else np.array(data)
        self._items[name] = dataset = _H5Dataset(value)
        return dataset

    def __getitem__(self, name: str):
        return self._items[name]

    def __contains__(self, name: str) -> bool:
        return name in self._items


class _H5File(_H5Group):
    """The part of ``h5py.File`` the port uses, stored as a pickle at the
    same path."""

    def __init__(self, path, mode: str = "r") -> None:
        import pickle

        super().__init__()
        self._path, self._mode = str(path), mode
        if mode == "r":
            with open(self._path, "rb") as f:
                self._items, self.attrs = pickle.load(f)

    def close(self) -> None:
        import pickle

        if self._mode != "r":
            with open(self._path, "wb") as f:
                pickle.dump((self._items, self.attrs), f)
            self._mode = "r"

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


STANDIN = "the h5py stand-in of scripts/torch_h5py_standin.py (h5py is not installed)"
"""What :func:`ensure_h5py` returns when it installed the stand-in."""


def ensure_h5py() -> str:
    """``h5py``, or the stand-in module in ``sys.modules`` where it is not
    installed. Returns what was used: ``"h5py <version>"`` or
    :data:`STANDIN`."""
    import importlib.util
    import types

    if "h5py" in sys.modules and getattr(sys.modules["h5py"], "File", None) is _H5File:
        return STANDIN
    if importlib.util.find_spec("h5py") is not None:
        import h5py

        return f"h5py {h5py.__version__}"
    module = types.ModuleType("h5py")
    module.File = _H5File
    sys.modules["h5py"] = module
    return STANDIN
