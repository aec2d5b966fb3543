"""Catalog row chunks as numpy structured arrays.

Capability parity with the reference ``yaw.datachunk``
(yaw/datachunk.py:43-351): a fixed attribute order
(``ra, dec, weights, redshifts, patch_ids, kappa``), a one-byte bit-flag
header (:class:`DataChunkInfo`) describing which optional columns exist —
the binary patch-cache format is byte-compatible with the reference —
int16 patch ids, and chunk create/pop/accessor helpers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.coordinates import AngularCoordinates

if TYPE_CHECKING:
    from numpy.typing import NDArray
    from typing_extensions import Self

__all__ = [
    "ATTR_ORDER",
    "DataChunk",
    "DataChunkInfo",
    "HandlesDataChunk",
    "PATCH_ID_DTYPE",
    "check_patch_ids",
]

PATCH_ID_DTYPE = "i2"
"""Patch ids are 16-bit integers: more than 32767 patches would exhaust
memory in the patch-pair covariance tensors anyway."""

ATTR_ORDER = ("ra", "dec", "weights", "redshifts", "patch_ids", "kappa")
"""Canonical attribute order in chunks and the binary cache format."""

_OPTIONAL_ATTRS = ("weights", "redshifts", "patch_ids", "kappa")


def check_patch_ids(patch_ids) -> None:
    """Ensure patch ids fit the 16-bit storage type."""
    info = np.iinfo(PATCH_ID_DTYPE)
    patch_ids = np.asarray(patch_ids)
    if patch_ids.min(initial=0) < info.min or patch_ids.max(initial=0) > info.max:
        raise ValueError(f"'patch_ids' must be in range [{info.min}, {info.max}]")


@dataclass
class DataChunkInfo:
    """Bit flags describing which optional chunk attributes are present.

    Serialises to a single big-endian byte whose bits follow
    :data:`ATTR_ORDER` (``ra``/``dec`` always set), matching the reference
    cache format byte-for-byte.
    """

    has_weights: bool = False
    has_redshifts: bool = False
    has_patch_ids: bool = False
    has_kappa: bool = False

    @classmethod
    def from_bytes(cls: type[Self], info_bytes: bytes) -> Self:
        state = int.from_bytes(info_bytes, byteorder="big")
        flags = {
            f"has_{attr}": bool(state & (1 << (i + 2)))
            for i, attr in enumerate(_OPTIONAL_ATTRS)
        }
        return cls(**flags)

    def to_bytes(self) -> bytes:
        state = 0b11  # ra and dec always present
        for i, attr in enumerate(_OPTIONAL_ATTRS):
            state |= getattr(self, f"has_{attr}") << (i + 2)
        return state.to_bytes(1, byteorder="big")

    def get_list(self) -> list[str]:
        """Names of the present attributes in canonical order."""
        attrs = ["ra", "dec"]
        attrs.extend(
            attr for attr in _OPTIONAL_ATTRS if getattr(self, f"has_{attr}")
        )
        return attrs

    def format(self, *, skip_patch_ids: bool = True) -> str:
        """Comma-joined list of present optional attributes for logging."""
        attrs = self.get_list()[2:]
        if skip_patch_ids and "patch_ids" in attrs:
            attrs.remove("patch_ids")
        return ", ".join(attrs) if attrs else "none"

    def copy(self) -> DataChunkInfo:
        return DataChunkInfo(
            has_weights=self.has_weights,
            has_redshifts=self.has_redshifts,
            has_patch_ids=self.has_patch_ids,
            has_kappa=self.has_kappa,
        )


class HandlesDataChunk:
    """Mixin for objects that carry a :class:`DataChunkInfo` description."""

    _chunk_info: DataChunkInfo

    @property
    def attrs(self) -> DataChunkInfo:
        """Description of the optional attributes this object provides."""
        return self._chunk_info

    @property
    def has_weights(self) -> bool:
        return self._chunk_info.has_weights

    @property
    def has_redshifts(self) -> bool:
        return self._chunk_info.has_redshifts

    @property
    def has_kappa(self) -> bool:
        return self._chunk_info.has_kappa

    @property
    def has_patch_ids(self) -> bool:
        return self._chunk_info.has_patch_ids

    def copy_chunk_info(self, *, drop_patch_ids: bool = False) -> DataChunkInfo:
        """Copy of the attribute description, optionally with the patch-id
        flag cleared (reference: yaw/datachunk.py:154)."""
        copy = self._chunk_info.copy()
        if drop_patch_ids:
            copy.has_patch_ids = False
        return copy


class DataChunk:
    """Factory and accessors for structured-array catalog chunks."""

    @staticmethod
    def create(
        ra: NDArray,
        dec: NDArray,
        *,
        weights: NDArray | None = None,
        redshifts: NDArray | None = None,
        patch_ids: NDArray | None = None,
        kappa: NDArray | None = None,
        degrees: bool = True,
        chkfinite: bool = True,
    ) -> NDArray:
        """Pack per-column arrays into a structured array chunk.

        Coordinates given in degrees are converted to radian; optionally
        validates that all values are finite.
        """
        values = dict(
            ra=np.deg2rad(ra) if degrees else np.asarray(ra, np.float64),
            dec=np.deg2rad(dec) if degrees else np.asarray(dec, np.float64),
        )
        for name, column in (
            ("weights", weights),
            ("redshifts", redshifts),
            ("kappa", kappa),
        ):
            if column is not None:
                values[name] = np.asarray(column, np.float64)
        if patch_ids is not None:
            check_patch_ids(patch_ids)
            values["patch_ids"] = np.asarray(patch_ids, PATCH_ID_DTYPE)

        lengths = {len(v) for v in values.values()}
        if len(lengths) != 1:
            raise ValueError("all columns must have the same length")
        (num_rows,) = lengths

        dtype = np.dtype(
            [
                (attr, PATCH_ID_DTYPE if attr == "patch_ids" else "f8")
                for attr in ATTR_ORDER
                if attr in values
            ]
        )
        chunk = np.empty(num_rows, dtype=dtype)

        # pure-f8 layouts interleave natively in one pass with a fused
        # finite check (the numpy loop allocates one bool temporary per
        # column, which is expensive to fault in for catalog-sized rows)
        f8_names = [n for n in values if n != "patch_ids"]
        from yet_another_wizz_tpu_torch import _native

        if (
            _native.enabled()
            and chkfinite
            and "patch_ids" not in values
            and num_rows > 65536
        ):
            columns = [
                np.ascontiguousarray(values[n], dtype=np.float64)
                for n in chunk.dtype.names
            ]
            view = np.lib.stride_tricks.as_strided(
                chunk.view(np.float64).reshape(-1),
                shape=(num_rows, len(columns)),
                strides=(chunk.dtype.itemsize, 8),
            )
            bad = _native.interleave_columns(columns, view)
            if bad >= 0:
                raise ValueError(
                    f"invalid values encountered in '{chunk.dtype.names[bad]}'"
                )
            return chunk

        for name, column in values.items():
            if chkfinite and not np.all(np.isfinite(column)):
                raise ValueError(f"invalid values encountered in '{name}'")
            chunk[name] = column
        return chunk

    @staticmethod
    def get_info(chunk: NDArray) -> DataChunkInfo:
        """Describe which optional columns a chunk contains."""
        fields = set(chunk.dtype.fields)
        return DataChunkInfo(
            **{f"has_{attr}": attr in fields for attr in _OPTIONAL_ATTRS}
        )

    @staticmethod
    def hasattr(chunk: NDArray, attr: str) -> bool:
        """Whether a chunk contains the named column (reference:
        yaw/datachunk.py:308)."""
        return attr in chunk.dtype.fields

    @staticmethod
    def getattr(chunk: NDArray, attr: str, default=None):
        """Access a column, returning ``default`` if it does not exist."""
        try:
            return chunk[attr]
        except (KeyError, ValueError):
            return default

    @staticmethod
    def get_coords(chunk: NDArray) -> AngularCoordinates:
        """The (ra, dec) columns as :class:`AngularCoordinates`."""
        return AngularCoordinates(
            np.column_stack([chunk["ra"], chunk["dec"]])
        )

    @staticmethod
    def pop(chunk: NDArray, attr: str) -> tuple[NDArray, NDArray]:
        """Split one column off a chunk; returns (rest, column)."""
        column = chunk[attr]
        keep = [name for name in chunk.dtype.names if name != attr]
        rest = np.empty(
            len(chunk), dtype=[(n, chunk.dtype.fields[n][0]) for n in keep]
        )
        for name in keep:
            rest[name] = chunk[name]
        return rest, column

    @staticmethod
    def hstack(*chunks: NDArray) -> NDArray:
        """Concatenate chunks with identical dtypes."""
        return np.concatenate(chunks)
