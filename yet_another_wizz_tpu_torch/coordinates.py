"""Angular coordinates and angular separations on the unit sphere.

Capability parity with the reference ``yaw.coordinates``
(yaw/coordinates.py:72-319): containers for (ra, dec)
pairs in radian and for angular separations, with conversions to/from
3-dimensional Euclidean (unit-sphere) coordinates and chord distances.

The functional core (``radec_to_xyz``, ``xyz_to_radec``, ``angle_to_chord``,
``chord_to_angle``, ``split_hi_lo``) is exposed at module level because the
TPU compute path (:mod:`yet_another_wizz_tpu_torch.ops`) consumes raw arrays, not
container objects. All math is float64 on the host; the device kernels
receive pre-split (hi, lo) float32 pairs to retain small-angle precision on
hardware without native float64.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from numpy.typing import ArrayLike, NDArray

__all__ = [
    "AngularCoordinates",
    "AngularDistances",
    "angle_to_chord",
    "chord_to_angle",
    "radec_to_xyz",
    "sgn",
    "split_hi_lo",
    "xyz_to_radec",
]


def sgn(values):
    """Sign with the convention sgn(0) = 1 (parity with the reference
    helper, yaw/coordinates.py:31-34)."""
    import numpy as _np

    return _np.where(_np.asarray(values) == 0, 1.0, _np.sign(values))


NATIVE_XYZ_THRESHOLD = 100_000
"""Above this length the native single-pass conversion is used (the numpy
expression allocates ~6 temporaries, which is expensive for catalog-sized
inputs on first touch)."""


def radec_to_xyz(ra: ArrayLike, dec: ArrayLike) -> NDArray:
    """Project (ra, dec) in radian onto the unit sphere.

    Returns an array of shape ``(N, 3)`` (float64).
    """
    ra = np.asarray(ra, dtype=np.float64)
    dec = np.asarray(dec, dtype=np.float64)
    if ra.ndim == 1 and ra.size > NATIVE_XYZ_THRESHOLD:
        from yet_another_wizz_tpu_torch import _native

        if _native.enabled():
            return _native.radec_to_xyz(ra, dec)
    cos_dec = np.cos(dec)
    return np.stack(
        [np.cos(ra) * cos_dec, np.sin(ra) * cos_dec, np.sin(dec)], axis=-1
    )


def xyz_to_radec(xyz: ArrayLike) -> tuple[NDArray, NDArray]:
    """Convert points in 3D Euclidean space to (ra, dec) in radian.

    The input does not need to be normalised. RA is wrapped to ``[0, 2pi)``.
    """
    xyz = np.atleast_2d(np.asarray(xyz, dtype=np.float64))
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]

    ra = np.arctan2(y, x) % (2.0 * np.pi)
    norm = np.sqrt(x * x + y * y + z * z)
    with np.errstate(invalid="ignore"):
        dec = np.arcsin(np.clip(z / norm, -1.0, 1.0))
    return ra, dec


def angle_to_chord(angle: ArrayLike) -> NDArray:
    """Convert angular separation (radian) to unit-sphere chord distance."""
    return 2.0 * np.sin(0.5 * np.asarray(angle, dtype=np.float64))


def chord_to_angle(chord: ArrayLike) -> NDArray:
    """Convert unit-sphere chord distance to angular separation (radian)."""
    chord = np.asarray(chord, dtype=np.float64)
    return 2.0 * np.arcsin(np.clip(chord / 2.0, -1.0, 1.0))


def split_hi_lo(values: ArrayLike) -> tuple[NDArray, NDArray]:
    """Split float64 values into a (hi, lo) pair of float32 arrays.

    ``hi + lo`` reproduces the float64 input to ~47 bits of precision; the
    device pair-count kernels use this representation to compute chord
    distances between nearby points far below float32 resolution.
    """
    values = np.asarray(values, dtype=np.float64)
    hi = values.astype(np.float32)
    lo = (values - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


class _ArrayContainer:
    """Shared behaviour for thin array-wrapper containers."""

    __slots__ = ("data",)

    data: NDArray

    @property
    def __array_interface__(self) -> dict:
        return self.data.__array_interface__

    def __repr__(self) -> str:
        return f"{type(self).__name__}[{len(self)}]"

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx):
        return type(self)(self.data[idx])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def copy(self):
        """Return a copy of this container."""
        return type(self)(self.data.copy())

    def tolist(self) -> list:
        """Return the wrapped data as a nested python list."""
        return self.data.tolist()


class AngularCoordinates(_ArrayContainer):
    """Container for angular (ra, dec) coordinates in radian.

    Wraps an ``(N, 2)`` float64 array and provides conversion to/from
    unit-sphere 3-vectors, spherical means and pairwise distances.
    Supports ``len()``, indexing/slicing, iteration and elementwise ``==``.
    """

    __slots__ = ()

    def __init__(self, data: ArrayLike) -> None:
        self.data = np.atleast_2d(np.asarray(data, dtype=np.float64))
        if self.data.ndim != 2 or self.data.shape[1] != 2:
            raise ValueError("invalid coordinate dimensions, expected 2")

    @classmethod
    def from_coords(cls, coords) -> AngularCoordinates:
        """Concatenate an iterable of :class:`AngularCoordinates`."""
        return cls(np.concatenate([np.asarray(c) for c in coords]))

    @classmethod
    def from_3d(cls, xyz: ArrayLike) -> AngularCoordinates:
        """Create from points in 3D Euclidean space (need not be unit)."""
        ra, dec = xyz_to_radec(xyz)
        return cls(np.column_stack([ra, dec]))

    def to_3d(self) -> NDArray:
        """Project onto the unit sphere; returns an ``(N, 3)`` array."""
        return radec_to_xyz(self.ra, self.dec)

    @property
    def ra(self) -> NDArray:
        """Right ascension in radian."""
        return self.data[:, 0]

    @property
    def dec(self) -> NDArray:
        """Declination in radian."""
        return self.data[:, 1]

    def __eq__(self, other) -> NDArray:
        if type(self) is not type(other):
            return NotImplemented
        return self.data == other.data

    __hash__ = None

    def mean(self, weights: ArrayLike | None = None) -> AngularCoordinates:
        """Weighted spherical mean, computed via the Euclidean embedding."""
        mean_xyz = np.average(self.to_3d(), weights=weights, axis=0)
        return type(self).from_3d(mean_xyz)

    def distance(self, other: AngularCoordinates) -> AngularDistances:
        """Pairwise (broadcast) angular distance to ``other``."""
        if not isinstance(other, AngularCoordinates):
            raise TypeError(f"cannot compute distance with type {type(other)}")
        diff = self.to_3d() - other.to_3d()
        chord = np.sqrt(np.sum(diff * diff, axis=-1))
        return AngularDistances.from_3d(chord)


class AngularDistances(_ArrayContainer):
    """Container for angular separations in radian.

    Wraps a 1-dim float64 array, converts to/from unit-sphere chord
    distances, and supports comparison and ``+``/``-`` arithmetic.
    """

    __slots__ = ()

    def __init__(self, data: ArrayLike) -> None:
        self.data = np.atleast_1d(np.asarray(data, dtype=np.float64))

    @classmethod
    def from_dists(cls, dists) -> AngularDistances:
        """Concatenate an iterable of :class:`AngularDistances`."""
        return cls(np.concatenate([np.asarray(d) for d in dists]))

    @classmethod
    def from_3d(cls, dists: ArrayLike) -> AngularDistances:
        """Create from unit-sphere chord distances (must be <= 2)."""
        dists = np.asarray(dists, dtype=np.float64)
        if np.any(dists > 2.0):
            raise ValueError("distance exceeds size of unit sphere")
        return cls(chord_to_angle(dists))

    def to_3d(self) -> NDArray:
        """Convert to unit-sphere chord distances."""
        return angle_to_chord(self.data)

    def __eq__(self, other) -> NDArray:
        if type(self) is not type(other):
            return NotImplemented
        return self.data == other.data

    __hash__ = None

    def __lt__(self, other) -> NDArray:
        if type(self) is not type(other):
            return NotImplemented
        return self.data < other.data

    def __le__(self, other) -> NDArray:
        if type(self) is not type(other):
            return NotImplemented
        return self.data <= other.data

    def __gt__(self, other) -> NDArray:
        if type(self) is not type(other):
            return NotImplemented
        return self.data > other.data

    def __ge__(self, other) -> NDArray:
        if type(self) is not type(other):
            return NotImplemented
        return self.data >= other.data

    def __add__(self, other) -> AngularDistances:
        if type(self) is not type(other):
            return NotImplemented
        return type(self)(self.data + other.data)

    def __sub__(self, other) -> AngularDistances:
        if type(self) is not type(other):
            return NotImplemented
        return type(self)(self.data - other.data)

    def min(self) -> AngularDistances:
        """Minimum separation as a length-1 container."""
        return type(self)(self.data.min())

    def max(self) -> AngularDistances:
        """Maximum separation as a length-1 container."""
        return type(self)(self.data.max())
