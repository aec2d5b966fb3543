"""Per-patch disk cache: binary data file plus YAML metadata.

Ported from the JAX package's ``catalog/patch.py``: each patch directory
holds ``data.bin`` (one :class:`~yet_another_wizz_tpu_torch.datachunk.
DataChunkInfo` header byte followed by raw float64 structured rows) and
``meta.yml`` (record count, sum of weights, cap center and radius). The
format is the JAX package's byte for byte (and the reference's), so a cache
written by either package opens in the other. :class:`Patch` lazily loads
columns from the cache; :class:`PatchWriter` appends chunks with buffering.
``yaml`` is imported only where metadata is read or written.
"""

from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.coordinates import AngularCoordinates, AngularDistances
from yet_another_wizz_tpu_torch.datachunk import (
    DataChunk,
    DataChunkInfo,
    HandlesDataChunk,
)

if TYPE_CHECKING:
    from numpy.typing import NDArray
    from typing_extensions import Self

__all__ = [
    "Metadata",
    "Patch",
    "PatchWriter",
    "read_patch_data",
    "write_patch_data",
]

DEFAULT_BUFFERSIZE = 65_536
"""Number of rows buffered by :class:`PatchWriter` before flushing."""


class Metadata:
    """Summary statistics of one patch: size, weight, bounding cap."""

    __slots__ = ("num_records", "sum_weights", "center", "radius")

    def __init__(
        self,
        *,
        num_records: int,
        sum_weights: float,
        center: AngularCoordinates,
        radius: AngularDistances,
    ) -> None:
        self.num_records = num_records
        self.sum_weights = sum_weights
        self.center = center
        self.radius = radius

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(num_records={self.num_records}, "
            f"sum_weights={self.sum_weights}, center={self.center.data[0]}, "
            f"radius={self.radius.data[0]})"
        )

    @classmethod
    def compute(
        cls: type[Self],
        coords: AngularCoordinates,
        *,
        weights: NDArray | None = None,
        center: AngularCoordinates | None = None,
    ) -> Self:
        """Compute metadata from patch coordinates (optionally around an
        externally fixed center)."""
        num_records = len(coords)
        sum_weights = (
            float(num_records) if weights is None else float(np.sum(weights))
        )
        if center is not None:
            if len(center) != 1:
                raise ValueError("'center' must be one single coordinate")
            center = center.copy()
        else:
            center = coords.mean(weights)
        radius = coords.distance(center).max()
        return cls(
            num_records=num_records,
            sum_weights=sum_weights,
            center=center,
            radius=radius,
        )

    @classmethod
    def from_dict(cls: type[Self], the_dict: dict) -> Self:
        """Restore an instance from :meth:`to_dict` builtins (reference
        Metadata is YamlSerialisable,
        yaw/catalog/patch.py:44)."""
        return cls(
            num_records=the_dict["num_records"],
            sum_weights=the_dict["sum_weights"],
            center=AngularCoordinates(the_dict["center"]),
            radius=AngularDistances(the_dict["radius"]),
        )

    def to_dict(self) -> dict:
        """YAML-compatible builtins describing this patch."""
        return dict(
            num_records=int(self.num_records),
            sum_weights=float(self.sum_weights),
            center=self.center.tolist()[0],
            radius=float(self.radius.tolist()[0]),
        )

    @classmethod
    def from_file(cls: type[Self], path: Path | str) -> Self:
        import yaml

        with Path(path).open() as f:
            return cls.from_dict(yaml.safe_load(f))

    def to_file(self, path: Path | str) -> None:
        import yaml

        with Path(path).open("w") as f:
            yaml.safe_dump(self.to_dict(), f)


def write_patch_data(path: Path | str, chunk: NDArray) -> None:
    """Write a structured-array chunk as a patch ``data.bin`` file."""
    info = DataChunk.get_info(chunk)
    with Path(path).open("wb") as f:
        f.write(info.to_bytes())
        chunk.tofile(f)


def read_patch_data(path: Path | str) -> tuple[DataChunkInfo, NDArray]:
    """Read a patch ``data.bin`` file back into a structured array."""
    with Path(path).open("rb") as f:
        info = DataChunkInfo.from_bytes(f.read(1))
        dtype = np.dtype([(attr, "f8") for attr in info.get_list()])
        raw = np.fromfile(f, dtype=np.byte)
    return info, raw.view(dtype)


class PatchWriter(HandlesDataChunk):
    """Buffered, append-mode writer for one patch's ``data.bin``: it
    flushes whenever its buffer holds ``buffersize`` rows or more."""

    __slots__ = ("cache_path", "buffersize", "_chunk_info", "_buffer", "_opened")

    def __init__(
        self,
        cache_path: Path | str,
        chunk_info: DataChunkInfo,
        buffersize: int = DEFAULT_BUFFERSIZE,
    ) -> None:
        self.cache_path = Path(cache_path)
        if self.cache_path.exists():
            raise FileExistsError(f"directory already exists: {self.cache_path}")
        self.cache_path.mkdir(parents=True)

        self.buffersize = int(buffersize)
        chunk_info = chunk_info.copy()
        chunk_info.has_patch_ids = False  # ids are implicit in the directory
        self._chunk_info = chunk_info
        self._buffer: list[NDArray] = []
        self._opened = False

    @property
    def data_path(self) -> Path:
        return self.cache_path / "data.bin"

    @property
    def num_buffered(self) -> int:
        return sum(len(chunk) for chunk in self._buffer)

    def process_chunk(self, chunk: NDArray) -> None:
        """Queue a chunk for writing; flushes when the buffer is full."""
        self._buffer.append(chunk)
        if self.num_buffered >= self.buffersize:
            self.flush()

    def flush(self) -> None:
        """Append all buffered rows to disk."""
        if not self._buffer:
            return
        mode = "ab" if self._opened else "wb"
        with self.data_path.open(mode) as f:
            if not self._opened:
                f.write(self._chunk_info.to_bytes())
                self._opened = True
            for chunk in self._buffer:
                chunk.tofile(f)
        self._buffer = []

    def finalize(self) -> None:
        """Flush pending rows, writing the header even for empty patches."""
        if not self._opened:
            mode_chunk = np.empty(
                0, dtype=[(a, "f8") for a in self._chunk_info.get_list()]
            )
            self._buffer.insert(0, mode_chunk)
        self.flush()


class Patch(HandlesDataChunk):
    """Lazy accessor for one cached patch directory."""

    __slots__ = ("cache_path", "meta", "_chunk_info")

    def __init__(self, cache_path: Path | str, center=None) -> None:
        self.cache_path = Path(cache_path)
        with self.data_path.open("rb") as f:
            self._chunk_info = DataChunkInfo.from_bytes(f.read(1))

        meta_path = self.cache_path / "meta.yml"
        if meta_path.exists():
            self.meta = Metadata.from_file(meta_path)
        else:
            _, data = read_patch_data(self.data_path)
            self.meta = Metadata.compute(
                DataChunk.get_coords(data),
                weights=DataChunk.getattr(data, "weights"),
                center=center,
            )
            self.meta.to_file(meta_path)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.meta}) @ {self.cache_path}"

    @property
    def data_path(self) -> Path:
        return self.cache_path / "data.bin"

    def load_data(self) -> NDArray:
        """Load the full structured data array from the cache."""
        _, data = read_patch_data(self.data_path)
        return data

    @property
    def coords(self) -> AngularCoordinates:
        """Coordinates of the patch points."""
        return DataChunk.get_coords(self.load_data())

    @property
    def weights(self) -> NDArray | None:
        """Weights of the patch points (None if absent)."""
        return DataChunk.getattr(self.load_data(), "weights")

    @property
    def redshifts(self) -> NDArray | None:
        """Redshifts of the patch points (None if absent)."""
        return DataChunk.getattr(self.load_data(), "redshifts")

    @property
    def kappa(self) -> NDArray | None:
        """Scalar field values of the patch points (None if absent)."""
        return DataChunk.getattr(self.load_data(), "kappa")
