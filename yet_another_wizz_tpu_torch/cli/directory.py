"""Project directory layout and typed file handles.

Ported from the JAX package's ``cli/directory.py`` (the reference's
``yaw.cli.directory`` and ``yaw.cli.handles``, yaw/cli/directory.py:66-416,
handles.py:22-241). The layout is the JAX package's, file for file, so a
project begun by one package resumes in the other::

    [project]/
        pipeline.yml        # the project setup
        pipeline.log        # file log of all pipeline runs
        .tasklock           # guards against concurrent runs
        cache/
            patch_centers.npy
            reference/{data,rand}/     # catalog caches
            unknown_{i}/{data,rand}/
        paircounts/{auto_ref.hdf, auto_unk_{i}.hdf, cross_{i}.hdf}
        estimate/{auto_ref, auto_unk_{i}, cross_{i}, nz_est_{i}}.{dat,smp,cov}
        true/nz_true_{i}.{dat,smp,cov}
        plots/*.png
"""

from __future__ import annotations

import contextlib
import contextvars
from pathlib import Path
from typing import TYPE_CHECKING, Generic, TypeVar

import numpy as np

from yet_another_wizz_tpu_torch.coordinates import AngularCoordinates

if TYPE_CHECKING:
    from collections.abc import Iterator

T = TypeVar("T")

__all__ = [
    "CacheHandle",
    "CorrDataHandle",
    "CorrFuncHandle",
    "HistDataHandle",
    "ProjectDirectory",
    "RedshiftDataHandle",
    "TomographyWrapper",
]


_CATALOG_MEMO: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "yawt_catalog_memo", default=None
)


@contextlib.contextmanager
def catalog_memo():
    """Memoise catalogs loaded through :class:`CacheHandle` for the
    duration of the context.

    Handles are rebuilt on every project-directory property access, so
    without the memo each task loads a FRESH (Lazy)Catalog instance from
    the same cache directory. The session tile cache keys blocks by weak
    catalog identity — cross-task block sharing (the reference sample
    recurring in every tomographic bin's cross-correlation) therefore
    requires the tasks to receive the SAME catalog objects, which this
    memo provides. Held by ``Pipeline.run`` together with the session
    tile cache (lazy mode only — memoising full in-memory catalogs for
    a whole run would hold every task's data simultaneously; the blocked
    path's default LazyCatalogs hold per-patch metadata only). A
    ContextVar keeps concurrent pipelines in different threads from
    clobbering each other's memo."""
    token = _CATALOG_MEMO.set({})
    try:
        yield
    finally:
        _CATALOG_MEMO.reset(token)


class Handle:
    """A typed path with existence check and load/save hooks."""

    def __init__(self, path: Path | str) -> None:
        self.path = Path(path)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.path})"

    def exists(self) -> bool:
        return self.path.exists()


class CacheHandle(Handle):
    """Cache directories of one data/random catalog pair."""

    @property
    def data(self) -> Handle:
        return Handle(self.path / "data")

    @property
    def rand(self) -> Handle:
        return Handle(self.path / "rand")

    @property
    def _sentinel(self) -> Path:
        return self.path / ".complete"

    @staticmethod
    def _catalog_complete(path: Path) -> bool:
        """Whether one catalog cache directory finished ingesting: every
        writer (streaming, collective multi-process, ``Catalog.to_cache``) writes
        ``patch_ids.bin`` as its final artifact, so its presence rules
        out a truncated cache left behind by a mid-stream crash."""
        return path.is_dir() and (path / "patch_ids.bin").exists()

    def exists(self, expect_rand: bool | None = None) -> bool:
        """Whether the pair was cached COMPLETELY.

        Accepts the pair sentinel the CLI writes after creating both
        catalogs, or — for caches produced through the public API or by
        earlier versions, which a resumed pipeline must not silently
        re-ingest with ``overwrite=True`` — per-catalog completeness via
        the ingestion writers' final artifact.

        ``expect_rand`` is the caller's knowledge of whether the setup
        configures a random catalog for this pair. When True, a missing
        or incomplete rand cache means incomplete REGARDLESS of the
        sentinel — a crash inside the overwrite window (old rand deleted,
        new one not yet written) must trigger re-ingestion on resume, not
        a silent run without randoms. When None (unknown), an absent rand
        directory is accepted so adopted data-only caches still count."""
        if not self._catalog_complete(self.data.path):
            return False
        if expect_rand:
            return self._catalog_complete(self.rand.path)
        if self._sentinel.exists():
            return True
        return (
            expect_rand is False
            or not self.rand.path.exists()
            or self._catalog_complete(self.rand.path)
        )

    def mark_complete(self) -> None:
        """Record that both catalogs of the pair finished ingesting
        (root-only in multi-process jobs; see :meth:`exists`)."""
        from yet_another_wizz_tpu_torch.parallel.distributed import run_on_root

        run_on_root(self._sentinel.touch)

    def clear_complete(self) -> None:
        """Drop the pair sentinel before re-ingesting, so a crash midway
        leaves the pair observably incomplete (root-only)."""
        from yet_another_wizz_tpu_torch.parallel.distributed import run_on_root

        run_on_root(lambda: self._sentinel.unlink(missing_ok=True))

    @staticmethod
    def _load(path: Path, lazy: bool):
        from yet_another_wizz_tpu_torch.catalog import Catalog, LazyCatalog

        memo = _CATALOG_MEMO.get()
        if memo is None:
            return (LazyCatalog if lazy else Catalog)(path)
        key = (path.resolve(), lazy)
        catalog = memo.get(key)
        if catalog is None:
            catalog = (LazyCatalog if lazy else Catalog)(path)
            memo[key] = catalog
        return catalog

    def load_data(self, *, lazy: bool = False):
        return self._load(self.data.path, lazy)

    def load_rand(self, *, lazy: bool = False):
        if not self.rand.path.exists():
            return None
        return self._load(self.rand.path, lazy)


class CorrFuncHandle(Handle):
    """Pair counts stored as HDF5."""

    def load(self):
        from yet_another_wizz_tpu_torch.correlation import load_corrfunc

        return load_corrfunc(self.path)

    def save(self, corrfunc) -> None:
        corrfunc.to_file(self.path)


class CorrDataHandle(Handle):
    """Sampled correlation data stored as the ASCII file triple."""

    def exists(self) -> bool:
        return self.path.with_suffix(".dat").exists()

    def load(self):
        from yet_another_wizz_tpu_torch.correlation import CorrData

        return CorrData.from_files(self.path)

    def save(self, corrdata) -> None:
        corrdata.to_files(self.path)


class RedshiftDataHandle(CorrDataHandle):
    def load(self):
        from yet_another_wizz_tpu_torch.redshifts import RedshiftData

        return RedshiftData.from_files(self.path)


class HistDataHandle(CorrDataHandle):
    def load(self):
        from yet_another_wizz_tpu_torch.redshifts import HistData

        return HistData.from_files(self.path)


class TomographyWrapper(Generic[T]):
    """Maps tomographic bin indices onto handles; the path template
    contains a ``?`` placeholder for the bin index."""

    def __init__(
        self, handle_cls: type[T], template: Path | str, indices
    ) -> None:
        self.handle_cls = handle_cls
        self.template = str(template)
        self.indices = tuple(indices)

    def __getitem__(self, index: int) -> T:
        if index not in self.indices:
            raise KeyError(f"invalid bin index: {index}")
        return self.handle_cls(self.template.replace("?", str(index)))

    def __iter__(self) -> Iterator[T]:
        for index in self.indices:
            yield self[index]

    def items(self):
        for index in self.indices:
            yield index, self[index]

    def __len__(self) -> int:
        return len(self.indices)

    def exists(self, *args, **kwargs) -> bool:
        return all(handle.exists(*args, **kwargs) for handle in self)


class _Subdirectory:
    def __init__(self, path: Path, indices) -> None:
        self.path = path
        self.indices = tuple(indices)
        self.path.mkdir(parents=True, exist_ok=True)


class CacheDirectory(_Subdirectory):
    """Catalog caches plus the shared patch centers."""

    @property
    def patch_center_file(self) -> Path:
        return self.path / "patch_centers.npy"

    @property
    def reference(self) -> CacheHandle:
        return CacheHandle(self.path / "reference")

    @property
    def unknown(self) -> TomographyWrapper[CacheHandle]:
        return TomographyWrapper(
            CacheHandle, self.path / "unknown_?", self.indices
        )

    def get_patch_centers(self) -> AngularCoordinates | None:
        """Shared patch centers (None until the first catalog is cached)."""
        if not self.patch_center_file.exists():
            return None
        return AngularCoordinates(np.load(self.patch_center_file))

    def set_patch_centers(self, centers: AngularCoordinates) -> None:
        """Store the shared patch centers; they may only be written once."""
        from yet_another_wizz_tpu_torch.parallel.distributed import run_on_root

        def write_on_root() -> None:
            if self.patch_center_file.exists():
                raise RuntimeError(
                    "overwriting existing patch centers not permitted"
                )
            np.save(self.patch_center_file, centers.data)

        # the collective outcome broadcast synchronises the processes and
        # re-raises a root-side error everywhere instead of deadlocking
        run_on_root(write_on_root)

    def ensure_patch_centers(self, centers: AngularCoordinates) -> None:
        """Store the shared patch centers unless already present.

        Multi-process-safe: the branch decision is root's filesystem view,
        broadcast so every process takes the same path (a local ``exists``
        check would race against root's in-flight write)."""
        from yet_another_wizz_tpu_torch.parallel.distributed import (
            broadcast,
            run_on_root,
        )

        if broadcast(self.patch_center_file.exists()):
            return
        run_on_root(np.save, self.patch_center_file, centers.data)


class PaircountsDirectory(_Subdirectory):
    @property
    def auto_ref(self) -> CorrFuncHandle:
        return CorrFuncHandle(self.path / "auto_ref.hdf")

    @property
    def auto_unk(self) -> TomographyWrapper[CorrFuncHandle]:
        return TomographyWrapper(
            CorrFuncHandle, self.path / "auto_unk_?.hdf", self.indices
        )

    @property
    def cross(self) -> TomographyWrapper[CorrFuncHandle]:
        return TomographyWrapper(
            CorrFuncHandle, self.path / "cross_?.hdf", self.indices
        )


class EstimateDirectory(_Subdirectory):
    @property
    def auto_ref(self) -> CorrDataHandle:
        return CorrDataHandle(self.path / "auto_ref")

    @property
    def auto_unk(self) -> TomographyWrapper[CorrDataHandle]:
        return TomographyWrapper(
            CorrDataHandle, self.path / "auto_unk_?", self.indices
        )

    @property
    def cross(self) -> TomographyWrapper[CorrDataHandle]:
        return TomographyWrapper(
            CorrDataHandle, self.path / "cross_?", self.indices
        )

    @property
    def nz_est(self) -> TomographyWrapper[RedshiftDataHandle]:
        return TomographyWrapper(
            RedshiftDataHandle, self.path / "nz_est_?", self.indices
        )


class TrueDirectory(_Subdirectory):
    @property
    def nz_true(self) -> TomographyWrapper[HistDataHandle]:
        return TomographyWrapper(
            HistDataHandle, self.path / "nz_true_?", self.indices
        )


class ProjectDirectory:
    """The root project directory with its subdirectory accessors."""

    def __init__(self, path: Path | str, bin_indices) -> None:
        from yet_another_wizz_tpu_torch.parallel.distributed import run_on_root

        self.path = Path(path)
        self.indices = tuple(bin_indices)
        self.path.mkdir(parents=True, exist_ok=True)
        run_on_root(
            self.indices_file.write_text,
            ",".join(str(i) for i in self.indices),
        )

    @property
    def indices_file(self) -> Path:
        return self.path / ".project_info"

    @property
    def config_path(self) -> Path:
        return self.path / "pipeline.yml"

    @property
    def log_path(self) -> Path:
        return self.path / "pipeline.log"

    @property
    def lock_path(self) -> Path:
        return self.path / ".tasklock"

    @property
    def cache(self) -> CacheDirectory:
        return CacheDirectory(self.path / "cache", self.indices)

    @property
    def paircounts(self) -> PaircountsDirectory:
        return PaircountsDirectory(self.path / "paircounts", self.indices)

    @property
    def estimate(self) -> EstimateDirectory:
        return EstimateDirectory(self.path / "estimate", self.indices)

    @property
    def true(self) -> TrueDirectory:
        return TrueDirectory(self.path / "true", self.indices)

    @property
    def plot_path(self) -> Path:
        path = self.path / "plots"
        path.mkdir(exist_ok=True)
        return path
