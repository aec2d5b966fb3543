"""Abstract base classes for serialisable and binned/patched containers.

Capability parity with the reference ``yaw.utils.abc``
(yaw/utils/abc.py:34-362): dictionary/HDF5/ASCII
serialisation interfaces, an :class:`Indexer` helper, and the
:class:`BinwiseData` / :class:`PatchwiseData` mixins that expose ``bins`` and
``patches`` accessors with compatibility checks.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path
from typing import TYPE_CHECKING, Generic, TypeVar, Union

if TYPE_CHECKING:
    from collections.abc import Callable, Iterator
    from typing import Any

    from h5py import Group
    from typing_extensions import Self

    from yet_another_wizz_tpu_torch.binning import Binning

TypeSliceIndex = Union[int, slice]

TypeKey = TypeVar("TypeKey")
TypeValue = TypeVar("TypeValue")

__all__ = [
    "AsciiSerializable",
    "BinwiseData",
    "HdfSerializable",
    "Indexer",
    "PatchwiseData",
    "Serialisable",
]


class Serialisable(ABC):
    """Interface for objects that convert to and from dictionaries."""

    @classmethod
    def from_dict(cls, the_dict: dict[str, Any]) -> Self:
        """Create a new instance from a dictionary of constructor kwargs."""
        return cls(**the_dict)

    @abstractmethod
    def to_dict(self) -> dict[str, Any]:
        """Represent this instance as a dictionary of constructor kwargs."""


class HdfSerializable(ABC):
    """Interface for objects that serialise to and from HDF5 groups/files."""

    @classmethod
    @abstractmethod
    def from_hdf(cls, source: Group) -> Self:
        """Restore an instance from an open HDF5 group."""

    @abstractmethod
    def to_hdf(self, dest: Group) -> None:
        """Serialise this instance into an open HDF5 group."""

    @classmethod
    def from_file(cls, path: Path | str) -> Self:
        """Restore an instance from an HDF5 file path."""
        import h5py

        with h5py.File(str(path), mode="r") as f:
            return cls.from_hdf(f)

    def to_file(self, path: Path | str) -> None:
        """Serialise this instance into a new HDF5 file.

        In multi-process jobs only the root process writes (all processes
        hold identical replicated results); the collective outcome
        broadcast makes the file visible to every process and re-raises a
        root-side write error everywhere instead of deadlocking. Mirrors
        the reference's root-guarded I/O
        (yaw/correlation/corrfunc.py:183-197).
        """
        from yet_another_wizz_tpu_torch.parallel.distributed import run_on_root

        def write_on_root() -> None:
            import h5py

            with h5py.File(str(path), mode="w") as f:
                self.to_hdf(f)

        run_on_root(write_on_root)


class AsciiSerializable(ABC):
    """Interface for objects that serialise to and from sets of ASCII files."""

    @classmethod
    @abstractmethod
    def from_files(cls, path_prefix: Path | str) -> Self:
        """Restore an instance from files at ``path_prefix.{dat,smp,...}``."""

    @abstractmethod
    def to_files(self, path_prefix: Path | str) -> None:
        """Write this instance to files at ``path_prefix.{dat,smp,...}``."""


class Indexer(Generic[TypeKey, TypeValue]):
    """Indexing/iteration adapter backed by a slicing callback.

    Wraps a function mapping an index or slice to a new container instance,
    and provides ``[]`` access plus iteration over integer indices.
    """

    __slots__ = ("_slice_fn", "_cursor")

    def __init__(self, slice_fn: Callable[[TypeKey], TypeValue]) -> None:
        self._slice_fn = slice_fn
        self._cursor = 0

    def __repr__(self) -> str:
        return f"{type(self).__name__}[]"

    def __getitem__(self, item: TypeKey) -> TypeValue:
        return self._slice_fn(item)

    def __next__(self) -> TypeValue:
        try:
            value = self._slice_fn(self._cursor)
        except IndexError as err:
            raise StopIteration from err
        self._cursor += 1
        return value

    def __iter__(self) -> Iterator[TypeValue]:
        self._cursor = 0
        return self


def _check_type(this, other, require: bool) -> bool:
    if isinstance(other, type(this)):
        return True
    if require:
        raise TypeError(f"{type(other)} is not compatible with {type(this)}")
    return False


class PatchwiseData(ABC):
    """Mixin for containers resolved into spatial patches."""

    @property
    @abstractmethod
    def num_patches(self) -> int:
        """Number of spatial patches."""

    @abstractmethod
    def _make_patch_slice(self, item: TypeSliceIndex) -> Self:
        """Create a new instance from a subset of patches."""

    @property
    def patches(self) -> Indexer[TypeSliceIndex, Self]:
        """Indexer over subsets of patches (index, slice, or iterate)."""
        return Indexer(self._make_patch_slice)

    def is_compatible(self, other: Any, *, require: bool = False) -> bool:
        """Check that ``other`` has the same type and number of patches."""
        if not _check_type(self, other, require):
            return False
        if self.num_patches != other.num_patches:
            if require:
                raise ValueError("number of patches does not match")
            return False
        return True


class BinwiseData(ABC):
    """Mixin for containers resolved into redshift bins."""

    @property
    @abstractmethod
    def binning(self) -> Binning:
        """The redshift binning of this container."""

    @property
    def num_bins(self) -> int:
        """Number of redshift bins."""
        return len(self.binning)

    @abstractmethod
    def _make_bin_slice(self, item: TypeSliceIndex) -> Self:
        """Create a new instance from a subset of bins."""

    @property
    def bins(self) -> Indexer[TypeSliceIndex, Self]:
        """Indexer over subsets of bins (index, slice, or iterate).

        Note that selecting a non-contiguous subset of bins produces a
        contiguous binning spanning the omitted bins.
        """
        return Indexer(self._make_bin_slice)

    def is_compatible(self, other: Any, *, require: bool = False) -> bool:
        """Check that ``other`` has the same type and identical binning."""
        if not _check_type(self, other, require):
            return False
        if self.binning != other.binning:
            if require:
                raise ValueError("binning does not match")
            return False
        return True
