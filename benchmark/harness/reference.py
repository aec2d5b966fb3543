"""The plain reference of a measurement: pair counts per redshift bin, patch
pair and scale, their jackknife, the estimators and n(z) with its covariance.

Written from the semantics of the upstream yet_another_wizz (van den Busch et
al. 2020), not from the program: it assigns every object to its patch from
the benchmark's centres, bins the reference by redshift, converts each scale
to angles at the bin centres with the benchmark's own cosmology, and counts
every pair within reach by brute force on the device in float64 (the control
runs the same code in float32). It imports NumPy and PyTorch only.

Counting conventions, as upstream:

- a pair counts in the interval ``(edge_k, edge_k+1]`` of its bin's edges,
  which are the scale limits and, with separation weights, ``resolution``
  log-spaced sub-edges over the whole range; a scale sums the intervals
  between the edges nearest its limits, each weighted by
  ``theta_mid^rweight`` normalised over the sub-intervals;
- the reference side (and for autocorrelations both sides) is binned by
  redshift, bins closed on the right; an autocorrelation counts ordered pairs
  and keeps patch pairs ``p <= q`` with the diagonal halved, and normalises
  with the same convention on the product of the sums of weights;
- jackknife sample ``k`` leaves out every patch pair that touches patch
  ``k``; the covariance is ``(N - 1)`` times the biased sample covariance.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from harness.cosmo import Planck15
from harness.inputs import nearest_center, radec_to_xyz

ROW_CHUNK = 2048
"""Rows of one block of candidate pairs."""
BLOCK_ELEMENTS = 1 << 24
"""Candidate pairs per block at most (columns are split beyond it)."""


@dataclass
class Sample:
    """One catalog as the reference sees it."""

    xyz: np.ndarray  # (N, 3) float64 unit vectors
    ra: np.ndarray
    dec: np.ndarray
    weights: np.ndarray
    bins: np.ndarray  # -1 outside the binning
    patches: np.ndarray


def make_sample(columns: dict, centers, bin_edges) -> Sample:
    xyz = radec_to_xyz(columns["ra"], columns["dec"])
    z = np.asarray(columns["redshifts"])
    # (edge_b, edge_b+1]: the first edge not below z closes the bin
    bins = np.searchsorted(bin_edges, z, side="left") - 1
    bins[(bins < 0) | (bins >= len(bin_edges) - 1)] = -1
    return Sample(
        xyz=xyz, ra=np.mod(columns["ra"], 2 * np.pi), dec=columns["dec"],
        weights=np.asarray(columns["weights"], dtype=np.float64),
        bins=bins.astype(np.int64), patches=nearest_center(xyz, centers),
    )


# -- scales and edges --------------------------------------------------------

def chord2(angle):
    return (2.0 * np.sin(0.5 * np.asarray(angle, dtype=np.float64))) ** 2


@dataclass
class Edges:
    """Per-bin union edges (padded by repeating the last) and the map from
    their intervals to the scales."""

    angles: np.ndarray  # (B, E)
    maps: np.ndarray  # (B, E - 1, S)
    num_scale_edges: int  # distinct scale limits (the least a count needs)


def build_edges(scales: dict, zmids, cosmology=None) -> Edges:
    cosmology = cosmology or Planck15()
    rmin = np.atleast_1d(np.asarray(scales["rmin"], dtype=np.float64))
    rmax = np.atleast_1d(np.asarray(scales["rmax"], dtype=np.float64))
    to_mpc = {"kpc": 1e-3, "Mpc": 1.0}[scales["unit"]]
    dist = cosmology.angular_diameter_distance(np.asarray(zmids))
    rweight = scales.get("rweight")
    per_bin, maps = [], []
    for d in dist:
        limits = np.stack([rmin * to_mpc / d, rmax * to_mpc / d], 1)  # (S, 2)
        if rweight is None:
            edges = np.unique(limits.ravel())
            weights = np.ones(len(edges) - 1)
        else:
            logs = np.log10(limits)
            sub = np.linspace(logs.min(), logs.max(), scales["resolution"] + 1)
            log_edges = np.unique(np.concatenate([sub, logs.ravel()]))
            edges = 10.0 ** log_edges
            mids = 10.0 ** (0.5 * (log_edges[:-1] + log_edges[1:]))
            weights = mids ** rweight
            weights /= weights.sum()
        scale_map = np.zeros((len(edges) - 1, len(limits)))
        for s, (lo, hi) in enumerate(limits):
            k_lo = int(np.argmin(np.abs(edges - lo)))
            k_hi = int(np.argmin(np.abs(edges - hi)))
            scale_map[k_lo:k_hi, s] = weights[k_lo:k_hi]
        per_bin.append(edges)
        maps.append(scale_map)
    width = max(len(e) for e in per_bin)
    angles = np.array([np.pad(e, (0, width - len(e)), mode="edge") for e in per_bin])
    padded = np.zeros((len(per_bin), width - 1, len(rmin)))
    for b, m in enumerate(maps):
        padded[b, :len(m)] = m
    num_scale_edges = len(np.unique(np.concatenate([rmin, rmax])))
    return Edges(angles=angles, maps=padded, num_scale_edges=num_scale_edges)


# -- pair counting -----------------------------------------------------------

def _strips(dec, dec0: float, height: float):
    return np.floor((dec - dec0) / height).astype(np.int64)


def _ra_ranges(ra_sorted, lo: float, hi: float):
    """Index ranges of a strip's ra-sorted points within [lo, hi] on the
    circle."""
    two_pi = 2.0 * np.pi
    if hi - lo >= two_pi:
        return [(0, len(ra_sorted))]
    pieces = [(max(lo, 0.0), min(hi, two_pi))]
    if lo < 0.0:
        pieces.append((lo + two_pi, two_pi))
    if hi > two_pi:
        pieces.append((0.0, hi - two_pi))
    return [
        (int(np.searchsorted(ra_sorted, a, "left")),
         int(np.searchsorted(ra_sorted, b, "right")))
        for a, b in pieces
    ]


def candidate_blocks(rows: Sample, cols: Sample, reach: float):
    """Blocks ``(row_indices, col_indices)`` that together hold every pair
    closer than ``reach`` radian: rows in declination strips of height
    ``reach``, sorted by right ascension and cut into chunks; a chunk meets
    the columns of its strip and the two beside it whose right ascension
    lies within the chunk's range widened by the largest ra difference a
    pair within ``reach`` can have at those declinations."""
    height = max(reach, 1e-6)
    dec0 = min(rows.dec.min(), cols.dec.min())
    strip_r = _strips(rows.dec, dec0, height)
    strip_c = _strips(cols.dec, dec0, height)
    order_r = np.lexsort((rows.ra, strip_r))
    order_c = np.lexsort((cols.ra, strip_c))
    strip_r, strip_c = strip_r[order_r], strip_c[order_c]
    ra_r, ra_c = rows.ra[order_r], cols.ra[order_c]
    first_c, start_c = np.unique(strip_c, return_index=True)
    end_c = np.append(start_c[1:], len(strip_c))
    bounds_c = dict(zip(first_c.tolist(), zip(start_c, end_c)))
    starts_r = np.unique(strip_r, return_index=True)
    ends_r = np.append(starts_r[1][1:], len(strip_r))
    sin_half = np.sin(0.5 * reach)
    for s, a, b in zip(starts_r[0], starts_r[1], ends_r):
        dec_far = max(abs(dec0 + (s - 1) * height), abs(dec0 + (s + 2) * height))
        cos_far = np.cos(min(dec_far, 0.5 * np.pi))
        ratio = sin_half / cos_far if cos_far > 0 else np.inf
        widen = np.inf if ratio >= 1.0 else 2.0 * np.arcsin(ratio) * (1 + 1e-6) + 1e-12
        for c0 in range(a, b, ROW_CHUNK):
            c1 = min(c0 + ROW_CHUNK, b)
            lo, hi = ra_r[c0] - widen, ra_r[c1 - 1] + widen
            pieces = []
            for t in (s - 1, s, s + 1):
                if t not in bounds_c:
                    continue
                u, v = bounds_c[t]
                for i0, i1 in _ra_ranges(ra_c[u:v], lo, hi):
                    if i1 > i0:
                        pieces.append(np.arange(u + i0, u + i1))
            if pieces:
                yield order_r[c0:c1], order_c[np.concatenate(pieces)]


@dataclass
class Counted:
    intervals: np.ndarray  # (B, P, P, E - 1) weighted counts, ordered pairs
    below: np.ndarray  # (B, P, P) weight of the pairs below every edge
    near: np.ndarray  # (L, B, P, P, E) weight of pairs within band l of edge e
    pairs_in_reach: int  # pairs within the row's largest edge (unordered if auto)
    num_points: int


def count_pairs(rows: Sample, cols: Sample, edges: Edges, num_patches: int, *,
                binned2: bool, auto: bool, device, dtype=torch.float64,
                bands=()) -> Counted:
    """Weighted pair counts per (bin, row patch, column patch, interval of
    the bin's edges), computed on ``device`` in ``dtype``; for each relative
    band in ``bands`` also the weight of the pairs whose squared chord lies
    within that band of an edge, by edge (pairs that a count in a lower
    precision may put on the other side)."""
    keep_r = rows.bins >= 0
    keep_c = cols.bins >= 0 if binned2 else np.ones(len(cols.bins), bool)
    rows = Sample(*(getattr(rows, f)[keep_r] for f in Sample.__dataclass_fields__))
    cols = Sample(*(getattr(cols, f)[keep_c] for f in Sample.__dataclass_fields__))
    num_bins, num_edges = edges.angles.shape
    thresholds = torch.as_tensor(chord2(edges.angles), dtype=dtype, device=device)
    widest = max(bands, default=0.0)
    reach = float(edges.angles.max()) * (1.0 + widest)

    def put(sample):
        return (torch.as_tensor(sample.xyz, dtype=dtype, device=device),
                torch.as_tensor(sample.weights, dtype=dtype, device=device),
                torch.as_tensor(sample.bins, device=device),
                torch.as_tensor(sample.patches, device=device))

    x1, w1, b1, p1 = put(rows)
    x2, w2, b2, p2 = put(cols)
    limit1 = thresholds[b1, -1] * (1.0 + widest)
    slots = num_bins * num_patches * num_patches
    acc = torch.zeros(slots * (num_edges + 1), dtype=dtype, device=device)
    near = torch.zeros(len(bands), slots * num_edges, dtype=dtype, device=device)
    in_reach = torch.zeros((), dtype=torch.int64, device=device)
    for idx_r, idx_c in candidate_blocks(rows, cols, reach):
        idx_r = torch.as_tensor(idx_r, device=device)
        step = max(1, BLOCK_ELEMENTS // len(idx_r))
        for start in range(0, len(idx_c), step):
            idx_cc = torch.as_tensor(idx_c[start:start + step], device=device)
            xr, xc = x1[idx_r], x2[idx_cc]
            d = (xr[:, None, 0] - xc[None, :, 0]) ** 2
            d += (xr[:, None, 1] - xc[None, :, 1]) ** 2
            d += (xr[:, None, 2] - xc[None, :, 2]) ** 2
            mask = d <= limit1[idx_r][:, None]
            if binned2:
                mask &= b1[idx_r][:, None] == b2[idx_cc][None, :]
            ii, jj = mask.nonzero(as_tuple=True)
            gi, gj = idx_r[ii], idx_cc[jj]
            dist, bins = d[ii, jj], b1[gi]
            table = thresholds[bins]
            # k: the pair lies in (edge_k-1, edge_k]; 0 is below every edge,
            # num_edges beyond the last (inside the widest band only)
            k = torch.searchsorted(table, dist[:, None]).squeeze(1)
            in_reach += (k < num_edges).sum()
            slot = (bins * num_patches + p1[gi]) * num_patches + p2[gj]
            weight = w1[gi] * w2[gj]
            acc.index_add_(0, slot * (num_edges + 1) + k, weight)
            if not bands:
                continue
            above = k.clamp(max=num_edges - 1)
            t_above = table.gather(1, above[:, None]).squeeze(1)
            t_below = table.gather(1, (k - 1).clamp(min=0)[:, None]).squeeze(1)
            # the first of equal edges: the bin's table repeats its last edge
            below = torch.searchsorted(table, t_below[:, None]).squeeze(1)
            for level, band in enumerate(bands):
                for edge, close in (
                    (above, (k < num_edges) & (t_above - dist <= band * t_above)),
                    (below, (k > 0) & (dist - t_below <= band * t_below)),
                ):
                    near[level].index_add_(0, (slot * num_edges + edge)[close],
                                           weight[close])
    acc = acc.double().cpu().numpy().reshape(
        num_bins, num_patches, num_patches, num_edges + 1)
    near = near.double().cpu().numpy().reshape(
        len(bands), num_bins, num_patches, num_patches, num_edges)
    pairs = int(in_reach.item())
    if auto:  # leave out each point's pair with itself, count each pair once
        pairs = (pairs - len(rows.bins)) // 2
    points = len(rows.bins) if auto else len(rows.bins) + len(cols.bins)
    return Counted(acc[..., 1:num_edges], acc[..., 0], near, pairs, points)


def _auto_convention(values, auto: bool):
    """Patch pairs ``p <= q``, the diagonal halved, for autocorrelations."""
    if not auto:
        return values
    num = values.shape[-1]
    return values * (np.triu(np.ones((num, num)), 1) + 0.5 * np.eye(num))


def to_scales(counted: Counted, edges: Edges, auto: bool):
    """Per-scale counts ``(S, B, P, P)`` in the stored convention; for each
    band ``(L, S, B, P, P)`` the most that the pairs within it can move them
    (each near pair's weight times the change of its scale weight across its
    edge); and ``(S, B, P, P)`` the weight below each scale's upper edge,
    every pair below the first edge included, times the bin's largest
    interval weight: what a count that subtracts cumulative sums at the
    scale's edges carries in its sums."""
    maps = edges.maps  # (B, E - 1, S)
    scales = np.einsum("bpqk,bks->sbpq", counted.intervals, maps)
    padded = np.pad(maps, ((0, 0), (1, 1), (0, 0)))  # (B, E + 1, S)
    step = np.abs(padded[:, 1:] - padded[:, :-1])  # (B, E, S): across edge e
    moves = np.einsum("lbpqe,bes->lsbpq", counted.near, step)
    cumulative = counted.below[..., None] + np.cumsum(counted.intervals, axis=-1)
    upper = np.array([[np.flatnonzero(maps[b, :, s]).max(initial=0)
                       for s in range(maps.shape[2])] for b in range(maps.shape[0])])
    largest = maps.max(axis=(1, 2))[:, None, None]
    carried = np.stack([cumulative[np.arange(maps.shape[0]), :, :, upper[:, s]] * largest
                        for s in range(maps.shape[2])])
    return (_auto_convention(scales, auto), _auto_convention(moves, auto),
            _auto_convention(carried, auto))


def sum_weights(sample: Sample, num_bins: int, num_patches: int, binned: bool,
                dtype=torch.float64):
    """``(B, P)`` sums of weights, accumulated in ``dtype``: per bin, or the
    patch total in every bin."""
    weights = torch.as_tensor(sample.weights, dtype=dtype)
    if binned:
        keep = torch.as_tensor(sample.bins >= 0)
        flat = torch.as_tensor(sample.bins * num_patches + sample.patches)[keep]
        sums = torch.zeros(num_bins * num_patches, dtype=dtype)
        sums.index_add_(0, flat, weights[keep])
        return sums.double().numpy().reshape(num_bins, num_patches)
    sums = torch.zeros(num_patches, dtype=dtype)
    sums.index_add_(0, torch.as_tensor(sample.patches), weights)
    return np.repeat(sums.double().numpy()[None, :], num_bins, axis=0)


# -- post: jackknife, estimators, n(z) ----------------------------------------

def jackknife(array):
    """Totals ``(B,)`` and leave-one-patch-out samples ``(P, B)`` of a
    ``(B, P, P)`` array."""
    num = array.shape[-1]
    samples = np.empty((num, array.shape[0]))
    for k in range(num):
        keep = np.ones(num, bool)
        keep[k] = False
        samples[k] = array[:, keep][:, :, keep].sum(axis=(1, 2))
    return array.sum(axis=(1, 2)), samples


def normalised(counts, sw1, sw2, auto: bool):
    norm = _auto_convention(sw1[:, :, None] * sw2[:, None, :], auto)
    c_tot, c_smp = jackknife(counts)
    n_tot, n_smp = jackknife(norm)
    return c_tot / n_tot, c_smp / n_smp


def _guard(denominator):
    """Bins with a zero denominator read NaN, as upstream's guarded
    estimators leave them."""
    return np.where(denominator == 0.0, np.nan, denominator)


def estimator(terms: dict):
    """Landy-Szalay with RR, Davis-Peebles otherwise; on totals or samples."""
    dd = terms["dd"]
    if "rr" in terms:
        dr = terms["dr"]
        rd = terms.get("rd", dr)
        return ((dd - dr) + (terms["rr"] - rd)) / _guard(terms["rr"])
    mixed = terms["rd"] if "rd" in terms else terms["dr"]
    return (dd - mixed) / _guard(mixed)


def _estimate(terms: dict):
    """An estimator's totals ``(B,)`` and samples ``(P, B)`` from the
    normalised terms ``{kind: (totals, samples)}``."""
    return (estimator({k: v[0] for k, v in terms.items()}),
            estimator({k: v[1] for k, v in terms.items()}))


def correlation_estimate(terms: dict):
    """A correlation function ``(B,)``, its jackknife samples and
    covariance."""
    data, samples = _estimate(terms)
    return data, samples, covariance(samples)


def redshift_estimate(cross: dict, auto: dict | None, dz):
    """n(z) ``(B,)``, its jackknife samples ``(P, B)`` and covariance from
    the normalised terms ``{kind: (totals, samples)}`` of the cross- and
    (optionally) the reference autocorrelation."""
    w_sp, w_sp_samples = _estimate(cross)
    w_ss = w_ss_samples = 1.0
    if auto is not None:
        w_ss, w_ss_samples = _estimate(auto)
    with np.errstate(invalid="ignore"):
        data = w_sp / np.sqrt(dz**2 * w_ss)
        samples = w_sp_samples / np.sqrt(dz[None, :] ** 2 * w_ss_samples)
    return data, samples, covariance(samples)


def covariance(samples):
    num = samples.shape[0]
    return np.cov(samples, rowvar=False, ddof=0) * (num - 1)
