"""Contiguous redshift bin edges with closed-left/right semantics.

Capability parity with the reference ``yaw.binning``
(yaw/binning.py:51-159): a :class:`Binning` container
with edge/center/width accessors, slicing and iteration, HDF5 round trips
(including the legacy v2 layout), and edge validation. The HDF5 group
layout (``edges`` dataset + ``closed`` string dataset + version tag) is
kept compatible so pair-count files interoperate with the reference.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.options import Closed
from yet_another_wizz_tpu_torch.utils import HDF_COMPRESSION, write_version_tag
from yet_another_wizz_tpu_torch.utils.abc import HdfSerializable, TypeSliceIndex

if TYPE_CHECKING:
    from collections.abc import Iterator
    from typing import Any

    from h5py import Group
    from numpy.typing import ArrayLike, NDArray
    from typing_extensions import Self

__all__ = ["Binning", "parse_binning", "load_legacy_binning"]


def parse_binning(
    edges: ArrayLike | None, *, optional: bool = False
) -> NDArray | None:
    """Coerce bin edges to a float64 array and validate them.

    A valid binning is a one-dimensional sequence of at least two strictly
    increasing values (``N + 1`` edges delimit ``N`` contiguous bins).
    ``None`` passes through unchanged when ``optional`` is set.
    """
    if edges is None:
        if optional:
            return None
        raise ValueError("bin edges are required but got None")

    edges = np.atleast_1d(np.asarray(edges, dtype=np.float64))
    if edges.ndim > 1:
        raise ValueError(
            f"bin edges must be one-dimensional, got {edges.ndim} dims"
        )
    if edges.size < 2:
        raise ValueError(f"need at least two bin edges, got {edges.size}")
    widths = np.diff(edges)
    if widths.min(initial=np.inf) <= 0.0:
        raise ValueError("bin edges must increase monotonically")
    return edges


class Binning(HdfSerializable):
    """A set of contiguous redshift bins defined by their edges.

    Args:
        edges:
            Monotonically increasing bin edges, including the rightmost edge.
        closed:
            Which side of each bin interval is closed, ``"left"`` or
            ``"right"`` (default).
    """

    __slots__ = ("closed", "edges")

    def __init__(
        self,
        edges: ArrayLike,
        closed: Closed | str = Closed.right,
    ) -> None:
        #: Which side of the bin intervals is closed.
        self.closed = Closed(closed)
        #: All bin edges, including the rightmost.
        self.edges = parse_binning(edges)

    # ---- derived views -------------------------------------------------

    @property
    def left(self) -> NDArray:
        """Left edges of the bins."""
        return self.edges[:-1]

    @property
    def right(self) -> NDArray:
        """Right edges of the bins."""
        return self.edges[1:]

    @property
    def mids(self) -> NDArray:
        """Centers of the bins."""
        return 0.5 * (self.left + self.right)

    @property
    def dz(self) -> NDArray:
        """Widths of the bins."""
        return self.right - self.left

    def copy(self) -> Self:
        """Return a copy of this binning."""
        return type(self)(self.edges.copy(), closed=self.closed)

    def digitize(self, redshifts: ArrayLike) -> NDArray:
        """Assign each redshift to a 1-based bin index.

        Matches ``numpy.digitize`` semantics: index 0 means below the first
        edge and ``len(self) + 1`` above the last; with ``closed == "right"``
        values exactly on an edge belong to the bin to the left.
        """
        return np.digitize(
            np.asarray(redshifts),
            self.edges,
            right=(self.closed == Closed.right),
        )

    # ---- sequence protocol ---------------------------------------------

    def __len__(self) -> int:
        return self.edges.size - 1

    def __getitem__(self, item: TypeSliceIndex) -> Binning:
        # a slice of bins maps to a slice of edges one element longer; go
        # through the per-bin (left, right) pairs so integer indexing,
        # negative indices and strides all behave like a length-N sequence
        lefts = np.atleast_1d(self.left[item])
        rights = np.atleast_1d(self.right[item])
        return type(self)(np.append(lefts, rights[-1]), closed=self.closed)

    def __iter__(self) -> Iterator[Binning]:
        return (self[i] for i in range(len(self)))

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, type(self)):
            return NotImplemented
        if self.closed != other.closed:
            return False
        return np.array_equal(self.edges, other.edges)

    __hash__ = None

    def __repr__(self) -> str:
        closed_left = self.closed == Closed.left
        interval = "{}{:.3f}...{:.3f}{}".format(
            "[" if closed_left else "(",
            self.edges[0],
            self.edges[-1],
            ")" if closed_left else "]",
        )
        return f"{len(self)} bins @ {interval}"

    # ---- HDF5 round trip -----------------------------------------------

    def to_hdf(self, dest: Group) -> None:
        write_version_tag(dest)
        dest.create_dataset("edges", data=self.edges, **HDF_COMPRESSION)
        dest.create_dataset("closed", data=str(self.closed))

    @classmethod
    def from_hdf(cls: type[Self], source: Group) -> Self:
        closed = source["closed"][()]
        if isinstance(closed, bytes):
            closed = closed.decode("utf-8")
        return cls(source["edges"][:], closed=closed)


def load_legacy_binning(source: Group) -> Binning:
    """Load a binning from the reference's pre-v3 HDF5 layout, where bins
    are stored as an ``(N, 2)`` dataset of (left, right) pairs named
    ``binning`` with the closed side in an attribute."""
    pairs = source["binning"]
    edges = np.concatenate([pairs[:, 0], pairs[-1:, 1]])
    return Binning(edges, closed=pairs.attrs["closed"])
