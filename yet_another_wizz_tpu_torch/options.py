"""String-enum option values used throughout the framework.

Capability parity with the reference ``yaw.options`` module
(yaw/options.py:25-208): fixed-choice string parameters
for bin closure, pair-count modes, binning generators, covariance kinds
and separation units.

Implemented as plain ``str``-subclass enums (no external ``strenum``
dependency).
"""

from __future__ import annotations

from enum import Enum

__all__ = [
    "BinMethod",
    "BinMethodAuto",
    "Closed",
    "CountMode",
    "CovKind",
    "NotSet",
    "ResamplingMethod",
    "Unit",
    "get_options",
]


class _NotSetMeta(type):
    def __repr__(cls) -> str:  # pragma: no cover - trivial
        return "NotSet"

    def __bool__(cls) -> bool:
        return False


class NotSet(metaclass=_NotSetMeta):
    """Sentinel for configuration values that are not set."""


class StrEnum(str, Enum):
    """Minimal ``StrEnum`` replacement: members compare and format as their
    string value."""

    def __str__(self) -> str:
        return self.value

    def __format__(self, spec: str) -> str:
        return format(self.value, spec)


class Closed(StrEnum):
    """Which side of a bin interval is closed."""

    right = "right"
    left = "left"


class CountMode(StrEnum):
    """Pair counting mode: ``n`` = number weights, ``k`` = scalar-field
    (kappa) weights; two characters select the mode for catalog 1 and 2."""

    nn = "nn"
    nk = "nk"
    kn = "kn"
    kk = "kk"


class BinMethodAuto(StrEnum):
    """Automatic redshift-bin generation methods."""

    linear = "linear"
    comoving = "comoving"
    logspace = "logspace"


class BinMethod(StrEnum):
    """Redshift-bin generation methods, including user-provided edges."""

    linear = "linear"
    comoving = "comoving"
    logspace = "logspace"
    custom = "custom"


class CovKind(StrEnum):
    """Kind of covariance matrix to compute from samples."""

    full = "full"
    diag = "diag"
    var = "var"


class ResamplingMethod(StrEnum):
    """Spatial-patch resampling method for uncertainty estimation.

    The reference (v3) implements jackknife only; bootstrap is restored here
    as required by the benchmark configurations (BASELINE.md config #3).
    """

    jackknife = "jackknife"
    bootstrap = "bootstrap"


class Unit(StrEnum):
    """Unit of correlation scales: physical (angular diameter distance),
    angular, or comoving transverse distance."""

    # transverse angular diameter distance
    kpc = "kpc"
    Mpc = "Mpc"
    # angular separation
    rad = "rad"
    deg = "deg"
    arcmin = "arcmin"
    arcsec = "arcsec"
    # transverse comoving distance
    kpc_h = "kpc/h"
    Mpc_h = "Mpc/h"


def get_options(enum: type[StrEnum]) -> tuple[str, ...]:
    """Tuple of the allowed string values of an option enum."""
    return tuple(str(option) for option in enum)
