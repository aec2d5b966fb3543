"""Matplotlib plotting helpers for binned data with uncertainties.

Ported from the JAX package's ``utils/plotting.py`` (the reference's
``yaw.utils.plotting``, yaw/utils/plotting.py:43-156): point/line/step
styles with uncertainty visualisation, a zero line, and correlation-matrix
images; all helpers are safe no-ops when matplotlib is unavailable.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

import numpy as np

if TYPE_CHECKING:
    from numpy.typing import NDArray

try:
    import matplotlib.pyplot as plt

    PLOTTING_ENABLED = True
except ImportError:  # pragma: no cover - matplotlib is present in CI
    plt = None
    PLOTTING_ENABLED = False

__all__ = [
    "PLOTTING_ENABLED",
    "correlation_matrix",
    "line_uncertainty",
    "point_uncertainty",
    "step_uncertainty",
    "zero_line",
]

Axis = Any


def check_plotting_enabled(func):
    """Return None gracefully when matplotlib is missing."""

    def wrapper(*args, **kwargs):
        if not PLOTTING_ENABLED:
            import warnings

            warnings.warn("matplotlib not available, skipping plot")
            return None
        return func(*args, **kwargs)

    return wrapper


def _get_axis(ax: Axis | None) -> Axis:
    return ax if ax is not None else plt.gca()


@check_plotting_enabled
def zero_line(*, ax: Axis | None = None) -> Axis:
    """Draw a thin black horizontal line at y = 0."""
    ax = _get_axis(ax)
    ax.axhline(0.0, color="k", lw=0.8, zorder=0)
    return ax


@check_plotting_enabled
def point_uncertainty(
    x: NDArray, y: NDArray, yerr: NDArray, *, ax: Axis | None = None, **kwargs
) -> Axis:
    """Points with error bars."""
    ax = _get_axis(ax)
    ax.errorbar(x, y, yerr, fmt=".", ls="none", **kwargs)
    return ax


@check_plotting_enabled
def line_uncertainty(
    x: NDArray, y: NDArray, yerr: NDArray, *, ax: Axis | None = None, **kwargs
) -> Axis:
    """Line with a transparent band marking the uncertainty."""
    ax = _get_axis(ax)
    (line,) = ax.plot(x, y, **kwargs)
    ax.fill_between(
        x, y - yerr, y + yerr, color=line.get_color(), alpha=0.2, lw=0
    )
    return ax


@check_plotting_enabled
def step_uncertainty(
    edges: NDArray, y: NDArray, yerr: NDArray, *, ax: Axis | None = None,
    **kwargs,
) -> Axis:
    """Histogram-style steps with a shaded uncertainty band."""
    ax = _get_axis(ax)
    stairs = ax.stairs(y, edges, **{k: v for k, v in kwargs.items() if v is not None})
    color = stairs.get_edgecolor()
    ax.stairs(
        y + yerr, edges, baseline=y - yerr, fill=True, alpha=0.2, color=color
    )
    return ax


@check_plotting_enabled
def correlation_matrix(
    corr: NDArray,
    *,
    ticks: NDArray | None = None,
    cmap: str = "RdBu_r",
    ax: Axis | None = None,
) -> Axis:
    """Image of a correlation matrix with a fixed [-1, 1] color range."""
    ax = _get_axis(ax)
    if ticks is not None:
        extent = (ticks[0], ticks[-1], ticks[0], ticks[-1])
    else:
        n = len(corr)
        extent = (-0.5, n - 0.5, -0.5, n - 0.5)
    image = ax.imshow(
        np.flipud(corr), cmap=cmap, vmin=-1.0, vmax=1.0, extent=extent
    )
    ax.figure.colorbar(image, ax=ax)
    return ax
