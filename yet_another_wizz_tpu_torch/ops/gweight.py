"""Per-pair separation weights for the direct counting mode.

The plain PyTorch version of the direct-mode block of the pair-count
kernels (``csrc/paircount.cu`` built with ``-DYAWT_DIRECT=1`` and ``2``):
the port of the JAX package's ``ops/gweight.py``.
Every step is a separate float32 tensor operation, so it rounds as the
kernel does (built without FMA contraction and without fast-math
transcendentals). See :class:`yet_another_wizz_tpu_torch.ops.thresholds.
DirectEdges` for the table layout and the exact-equivalence argument
versus the reference's union-edge histogram (yaw/catalog/trees.py:84-117).

Grids confined to small angles (every survey-relevant configuration; gate
:data:`THETA_POLY_MAX`) take the small-angle path — ``log10(theta)``
straight from the squared chord through one log and a short polynomial,
no sqrt/arcsine — while wider grids keep the explicit
``sqrt -> arcsine -> log`` chain.

:func:`entry_layout` regroups the table's below/above entries by
(bin, sub-interval), the form in which the direct-mode kernels read them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "THETA_POLY_MAX",
    "EntryLayout",
    "apply_direct_weight",
    "counting_width",
    "entry_layout",
    "num_param_cols",
]

_INV_LN10 = 0.43429448190325176
_PI_2 = 1.5707963267948966

THETA_POLY_MAX = 1.2
"""Largest grid edge (radians) for the small-angle direct path.

``log10(theta)`` decomposes as ``0.5 * log10(chord2) + h(chord2 / 4)``
with ``h(y) = log10(asin(sqrt(y)) / sqrt(y))`` — analytic in ``y``, so a
degree-4 polynomial (times ``y``; ``h(0) = 0`` exactly) covers
``theta <= 1.2 rad`` to 3.7e-8 in float64; the float32 evaluation lands
at 6.0e-7 max error in ``log10(theta)``, the same error class as the
explicit chain's 6.2e-7. Pairs beyond the grid cannot leak through the
gate: scale limits compare ``chord2`` directly, pairs above the largest
counting edge enter no cumulative sum, and pairs below the smallest
cancel between the two edge sums that bracket their scale."""

_H_POLY = (
    # power-basis coefficients of h(y)/y over [0, sin^2(THETA_POLY_MAX/2)],
    # a0 + a1 y + ... + a4 y^4
    0.072382861485278921,
    0.026515311180259658,
    0.015040318719047438,
    0.0068128827079525812,
    0.014413456335465801,
)


def num_param_cols(num_below: int, num_above: int) -> int:
    """Width of the per-bin parameter block appended to the threshold
    table: ``[inv_d, lo_scaled, gc0, gc1]`` plus 3 columns per entry."""
    return 4 + 3 * (num_below + num_above)


def counting_width(num_table_cols: int, direct: tuple | None) -> int:
    """Counting-edge columns of a (possibly combined) threshold table:
    the full width in cumulative mode, the width minus the parameter
    block in direct mode (``direct = (num_sub, num_below, num_above)``).
    Raises for a table without counting edges."""
    width = num_table_cols
    if direct is not None:
        width -= num_param_cols(direct[1], direct[2])
    if width < 1:
        raise ValueError(
            f"table of width {num_table_cols} has no counting edges for the "
            f"direct specification {direct}"
        )
    return width


class EntryLayout(NamedTuple):
    """The below/above entries of a direct-mode parameter block, grouped
    by (bin, sub-interval).

    Attributes:
        spans: int32 ``(B, num_sub, 3)``: ``start, split, stop`` of each
            sub-interval's entries; ``entries[start:split]`` are its
            below-entries, ``entries[split:stop]`` its above-entries, each
            in table order.
        entries: float32 ``(N, 2)``: ``(thr_chord2, g)`` of every entry
            whose ``k`` names a sub-interval of the grid (padding entries,
            ``k = -1``, are left out: no pair's index equals them).
    """

    spans: np.ndarray
    entries: np.ndarray

    def packed(self) -> np.ndarray:
        """One int32 array, the spans followed by the entries' float32
        bits: the buffer the kernels copy into shared memory."""
        return np.concatenate(
            [self.spans.ravel(), self.entries.view(np.int32).ravel()]
        )


def entry_layout(
    params: np.ndarray, *, num_sub: int, num_below: int, num_above: int
) -> EntryLayout:
    """Group the entries of the ``(B, num_param_cols(...))`` parameter
    block by (bin, sub-interval). A pair in sub-interval ``k`` of its
    row's bin then walks only the entries with that ``k``, below-entries
    first, in table order, which is what :func:`apply_direct_weight`'s
    walk over all entries leaves in effect (an entry applies only where
    ``idx == k``, and the later entry wins)."""
    params = np.asarray(params, np.float32)
    num_bins = params.shape[0]
    num_entries = num_below + num_above
    cols = params[:, 4 : 4 + 3 * num_entries].reshape(num_bins, num_entries, 3)
    k = cols[..., 0]
    in_grid = (k >= 0) & (k < num_sub) & (k == np.floor(k))
    above = np.arange(num_entries) >= num_below
    bins = np.arange(num_bins)[:, None]
    # entries sort by (bin, k, below before above); a stable sort keeps
    # the table order within each group
    key = ((bins * num_sub + np.where(in_grid, k, 0).astype(np.int64)) * 2
           + above)[in_grid]
    order = np.argsort(key, kind="stable")
    entries = np.ascontiguousarray(cols[in_grid][order][:, 1:], np.float32)
    counts = np.bincount(key, minlength=2 * num_bins * num_sub).reshape(-1, 2)
    stop = np.cumsum(counts.sum(axis=1))
    start = stop - counts.sum(axis=1)
    spans = np.stack([start, start + counts[:, 0], stop], axis=1)
    return EntryLayout(
        spans=spans.astype(np.int32).reshape(num_bins, num_sub, 3),
        entries=entries.reshape(-1, 2),
    )


def _asin_f32(s: torch.Tensor) -> torch.Tensor:
    """Branchless float32 arcsine on [0, 1]: the Cephes single-precision
    minimax polynomial on [0, 0.5], and ``asin(s) = pi/2 - 2 asin(sqrt((1
    - s) / 2))`` above (the JAX package's ``_asin_f32``)."""
    big = s > 0.5
    t = torch.where(
        big, torch.sqrt(torch.clamp(0.5 * (1.0 - s), min=0.0)), s
    )
    z = t * t
    p = 4.2163199048e-2 * z
    p = (p + 2.4181311049e-2) * z
    p = (p + 4.5470025998e-2) * z
    p = (p + 7.4953002686e-2) * z
    p = p + 1.6666752422e-1
    r = t + (t * z) * p
    return torch.where(big, _PI_2 - 2.0 * r, r)


def apply_direct_weight(
    chord2: torch.Tensor,
    params: torch.Tensor,
    weights: torch.Tensor,
    *,
    num_sub: int,
    num_below: int,
    num_above: int,
    small_angle: bool = False,
) -> torch.Tensor:
    """Multiply pair ``weights`` by the normalised separation weight.

    Args:
        chord2: ``(..., R, C)`` float32 squared chord distances.
        params: ``(..., R, P)`` per-row parameter block (the row bin's
            entry of the table; ``P == num_param_cols(...)``).
        weights: ``(..., R, C)`` effective column weights to scale.
        num_sub / num_below / num_above: grid configuration, see
            :class:`~yet_another_wizz_tpu_torch.ops.thresholds.DirectEdges`.

    The sub-interval index comes from the uniform log grid in O(1):
    ``floor(log10(theta) * inv_d - lo_scaled)``; the base weight is
    ``exp(gc0 + gc1 * idx)`` and the below/above entries repair the
    sub-intervals split by interior scale limits. Pairs outside the grid
    clip to the end intervals, where their weight cannot reach an output.
    """
    inv_d = params[..., 0:1]
    lo_scaled = params[..., 1:2]
    gc0 = params[..., 2:3]
    gc1 = params[..., 3:4]

    if small_angle:
        y = 0.25 * chord2
        p = _H_POLY[4] * y
        for a in (_H_POLY[3], _H_POLY[2], _H_POLY[1]):
            p = (p + a) * y
        p = p + _H_POLY[0]
        # clamp to a float32-NORMAL value: log(0) = -inf would turn into
        # NaN against the zero inv_d of padded empty bins
        log10_theta = (0.5 * _INV_LN10) * torch.log(
            torch.clamp(chord2, min=1e-37)
        ) + p * y
    else:
        s = torch.clamp(0.5 * torch.sqrt(chord2), max=1.0)
        theta = 2.0 * _asin_f32(s)
        log10_theta = torch.log(torch.clamp(theta, min=1e-30)) * _INV_LN10
    idx = torch.clamp(
        torch.floor(log10_theta * inv_d - lo_scaled), 0.0, float(num_sub - 1)
    )
    g = torch.exp(gc0 + gc1 * idx)

    col = 4
    for _ in range(num_below):
        k = params[..., col : col + 1]
        thr = params[..., col + 1 : col + 2]
        value = params[..., col + 2 : col + 3]
        g = torch.where((idx == k) & (chord2 <= thr), value, g)
        col += 3
    # ascending above-entries: a pair lands on the highest limit below it
    for _ in range(num_above):
        k = params[..., col : col + 1]
        thr = params[..., col + 1 : col + 2]
        value = params[..., col + 2 : col + 3]
        g = torch.where((idx == k) & (chord2 > thr), value, g)
        col += 3
    return weights * g
