"""Angular-edge tables for per-redshift-bin cumulative pair counting.

The engine counts pairs cumulatively against a table of squared-chord
thresholds per (redshift bin, edge); interval counts and the mapping to the
requested scale ranges (including the optional power-law separation
weighting ``w(theta) ~ theta^alpha``) are recovered on the host in float64.

Semantics mirror the reference kernel exactly
(yaw/catalog/trees.py:84-160): per bin, the edge set is
the union of all scale limits and, when weighting is enabled, ``resolution``
logarithmically spaced sub-edges spanning the overall range; counts fall in
half-open intervals ``(edge_k, edge_{k+1}]``; sub-bin counts are scaled by
``theta_mid^alpha`` normalised over all sub-bins; scale totals sum the
sub-intervals whose edges are nearest to the scale limits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.coordinates import angle_to_chord

if TYPE_CHECKING:
    from numpy.typing import NDArray

    from yet_another_wizz_tpu_torch.cosmology import Scales, TypeCosmology

__all__ = [
    "AngularEdges",
    "build_angular_edges",
    "validate_angle_range",
]

DIRECT_CROSSOVER = 12
"""Number of union edges at which the JAX package switches
separation-weighted counting to its direct per-pair-weight formulation
(the analogue of the reference's cumulative-vs-binned heuristic at 8
angular bins, yaw/catalog/trees.py:341). The direct mode is not ported
yet, so ``counting="auto"`` raises where the JAX package would pick it."""


def validate_angle_range(ang_min: NDArray, ang_max: NDArray) -> NDArray:
    """Validate per-scale angular limits: 1-dim, matching lengths,
    ``min < max``, all within ``[0, pi]``. Returns an ``(S, 2)`` array."""
    ang_min = np.atleast_1d(np.asarray(ang_min, dtype=np.float64))
    ang_max = np.atleast_1d(np.asarray(ang_max, dtype=np.float64))

    if ang_min.ndim != 1 or ang_max.ndim != 1:
        raise ValueError("'ang_min' and 'ang_max' must be 1-dim")
    if len(ang_min) != len(ang_max):
        raise ValueError("length of 'ang_min' and 'ang_max' does not match")
    limits = np.column_stack((ang_min, ang_max))
    if not np.all(np.isfinite(limits)):
        # NaN passes every comparison check below as False and would
        # silently collapse the measurement to zero counts (NaN cutoff
        # links no patch pair)
        raise ValueError("'ang_min' and 'ang_max' must be finite")
    if np.any(ang_min >= ang_max):
        raise ValueError("'ang_min' < 'ang_max' not satisfied")
    if np.any(limits < 0.0) or np.any(limits > np.pi):
        raise ValueError("'ang_min' and 'ang_max' not in range [0.0, pi]")
    return limits


def _edges_for_limits(
    limits: NDArray, weight_scale: float | None, weight_res: int
) -> NDArray:
    """Edge set for one redshift bin: scale limits plus optional log-spaced
    sub-edges for separation weighting."""
    if weight_scale is None:
        # no log roundtrip: keeps the user's edges exact to the ulp and
        # avoids log10(0) warnings for the valid ang_min=0 case
        return np.sort(np.unique(limits.ravel()))
    log_limits = np.log10(limits)
    sub = np.linspace(log_limits.min(), log_limits.max(), weight_res + 1)
    log_edges = np.concatenate([sub, log_limits.ravel()])
    return 10.0 ** np.sort(np.unique(log_edges))


def _interval_weights(
    edges: NDArray, weight_scale: float | None
) -> NDArray:
    """Per-interval multiplicative weights from the power-law separation
    weighting (all ones when disabled)."""
    if weight_scale is None:
        return np.ones(len(edges) - 1)
    log_edges = np.log10(edges)
    mids = 10.0 ** (0.5 * (log_edges[:-1] + log_edges[1:]))
    w = mids**weight_scale
    return w / w.sum()


def _scale_map(edges: NDArray, limits: NDArray, weights: NDArray) -> NDArray:
    """Matrix ``(num_intervals, S)`` mapping weighted interval counts to the
    requested scale ranges (nearest-edge selection)."""
    num_intervals = len(edges) - 1
    mapping = np.zeros((num_intervals, len(limits)))
    for s, (lo, hi) in enumerate(limits):
        idx_lo = int(np.argmin(np.abs(edges - lo)))
        idx_hi = int(np.argmin(np.abs(edges - hi)))
        mapping[idx_lo:idx_hi, s] = weights[idx_lo:idx_hi]
    return mapping


@dataclass
class AngularEdges:
    """Per-redshift-bin angular edges, chord thresholds and scale mapping.

    Attributes:
        chord2_table:
            float32 ``(B, E)`` squared-chord thresholds (per-bin edge sets
            padded to the widest bin by repeating the last edge, which
            creates empty intervals).
        edges:
            float64 ``(B, E)`` angular edges (same padding).
        scale_maps:
            float64 ``(B, E - 1, S)`` interval-to-scale mapping including
            separation weights; padded intervals map to zero.
        max_angle:
            largest angular edge over all bins (the linkage cutoff).
    """

    chord2_table: NDArray
    edges: NDArray
    scale_maps: NDArray
    max_angle: float

    @property
    def num_bins(self) -> int:
        return self.edges.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[1]

    @property
    def num_counting_edges(self) -> int:
        """Width of the engine's output edge axis: all union edges."""
        return self.num_edges

    @property
    def num_scales(self) -> int:
        return self.scale_maps.shape[2]

    def counts_to_scales(self, cumulative: NDArray) -> NDArray:
        """Convert cumulative counts ``(..., B, E)`` into per-scale counts
        ``(S, ..., B)`` in float64."""
        cumulative = np.asarray(cumulative, dtype=np.float64)
        intervals = np.diff(cumulative, axis=-1)  # (..., B, E-1)
        # sum_k intervals[..., b, k] * scale_maps[b, k, s]
        scales = np.einsum("...bk,bks->s...b", intervals, self.scale_maps)
        return scales


def build_angular_edges(
    scales: Scales,
    zmids: NDArray,
    cosmology: TypeCosmology | None = None,
    *,
    weight_scale: float | None = None,
    weight_res: int = 50,
    counting: str = "auto",
) -> AngularEdges:
    """Build the per-bin edge tables for a set of correlation scales.

    The scale limits are converted to angles at each redshift-bin center
    (mirroring yaw/correlation/measurements.py:110-112).

    ``counting`` selects the device formulation for separation-weighted
    configurations. Only ``cumulative`` (union-edge passes) is ported:
    ``direct``, and ``auto`` where the JAX package would pick the direct
    mode (at :data:`DIRECT_CROSSOVER` union edges), raise
    ``NotImplementedError``.
    """
    if counting not in ("auto", "cumulative", "direct"):
        raise ValueError(f"unknown counting mode '{counting}'")
    if counting == "direct":
        raise NotImplementedError("direct counting is not ported yet")
    zmids = np.atleast_1d(np.asarray(zmids, dtype=np.float64))

    per_bin_edges = []
    per_bin_maps = []
    for z in zmids:
        ang_min, ang_max = scales.get_angle_radian(z, cosmology=cosmology)
        limits = validate_angle_range(ang_min, ang_max)
        if weight_scale is not None and np.any(limits <= 0.0):
            # the log-spaced sub-edge grid (and the direct-mode
            # coefficients) work in log10(theta): a zero lower limit
            # would silently turn every weighted count into NaN
            raise ValueError(
                "separation weighting requires strictly positive "
                f"angular limits, got ang_min=0 at z={z:.4g}"
            )
        edges = _edges_for_limits(limits, weight_scale, weight_res)
        weights = _interval_weights(edges, weight_scale)
        per_bin_edges.append(edges)
        per_bin_maps.append(_scale_map(edges, limits, weights))

    num_scales = per_bin_maps[0].shape[1]
    max_edges = max(len(e) for e in per_bin_edges)
    num_bins = len(zmids)

    edges = np.empty((num_bins, max_edges))
    scale_maps = np.zeros((num_bins, max_edges - 1, num_scales))
    for b, (e, m) in enumerate(zip(per_bin_edges, per_bin_maps)):
        edges[b, : len(e)] = e
        edges[b, len(e) :] = e[-1]  # padded edges yield empty intervals
        scale_maps[b, : m.shape[0], :] = m

    if (
        weight_scale is not None
        and counting == "auto"
        and max_edges >= DIRECT_CROSSOVER
    ):
        raise NotImplementedError(
            "direct counting is not ported yet; pass counting='cumulative'"
        )

    chord2 = angle_to_chord(edges) ** 2
    return AngularEdges(
        chord2_table=chord2.astype(np.float32),
        edges=edges,
        scale_maps=scale_maps,
        max_angle=float(edges.max()),
    )
