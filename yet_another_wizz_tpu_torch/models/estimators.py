"""Correlation estimators: pair counts -> correlation amplitude.

Capability parity with the reference's estimator functions
(yaw/correlation/corrfunc.py:69-97); registered by
their conventional short names so they can be selected explicitly
(``get_estimator("LS")``) in addition to the automatic choice made by
:class:`~yet_another_wizz_tpu_torch.correlation.corrfunc.CorrFunc`.

All estimators are pure elementwise algebra on (samples of) patch-summed,
normalised pair counts, applied identically to data vectors and to every
resampled realisation.
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from collections.abc import Callable

    from numpy.typing import NDArray

logger = logging.getLogger(__name__)

__all__ = [
    "ESTIMATORS",
    "EstimatorError",
    "davis_peebles",
    "get_estimator",
    "landy_szalay",
    "scalar_correlation",
]


class EstimatorError(Exception):
    pass


def _named(key: str):
    def decorator(func):
        func.name = key
        return func

    return decorator


def _guard_denominator(denom: NDArray, *, term: str, name: str) -> NDArray:
    """Mask zero-valued denominator bins to NaN instead of emitting inf.

    Empty random bins otherwise poison downstream covariances silently
    (the reference shares this flaw, yaw/correlation/
    corrfunc.py:81-88: it divides unguarded and relies on numpy warnings).
    A single warning is logged per offending call.
    """
    denom = np.asarray(denom, dtype=np.float64)
    mask = denom == 0.0
    if not np.any(mask):
        return denom
    logger.warning(
        "%s estimator: %d bin(s) with %s=0 set to NaN", name, int(np.sum(mask)), term
    )
    guarded = denom.copy()
    guarded[mask] = np.nan
    return guarded


@_named("DP")
def davis_peebles(
    *, dd: NDArray, dr: NDArray | None = None, rd: NDArray | None = None
) -> NDArray:
    """Davis-Peebles estimator ``(DD - DR) / DR`` (or with RD)."""
    if dr is None and rd is None:
        raise EstimatorError("either 'dr' or 'rd' are required")
    mixed = dr if rd is None else rd
    mixed = _guard_denominator(mixed, term="DR" if rd is None else "RD", name="DP")
    return (dd - mixed) / mixed


@_named("LS")
def landy_szalay(
    *, dd: NDArray, dr: NDArray, rd: NDArray | None = None, rr: NDArray
) -> NDArray:
    """Landy-Szalay estimator ``(DD - DR - RD + RR) / RR``."""
    if rd is None:
        rd = dr
    rr = _guard_denominator(rr, term="RR", name="LS")
    return ((dd - dr) + (rr - rd)) / rr


@_named("SC")
def scalar_correlation(*, dd: NDArray, dr: NDArray | None = None) -> NDArray:
    """Scalar-field estimator: normalised kappa counts, optionally with the
    random term subtracted."""
    return dd if dr is None else dd - dr


ESTIMATORS: dict[str, Callable[..., "NDArray"]] = {
    "DP": davis_peebles,
    "LS": landy_szalay,
    "SC": scalar_correlation,
}
"""Registry of estimator models by conventional short name."""


def get_estimator(name: str) -> Callable[..., "NDArray"]:
    """Look up an estimator model by name (``DP``, ``LS`` or ``SC``)."""
    try:
        return ESTIMATORS[name.upper()]
    except KeyError:
        options = ", ".join(ESTIMATORS)
        raise ValueError(
            f"unknown estimator '{name}', registered: {options}"
        ) from None
