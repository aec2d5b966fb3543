"""Inputs that probe the chunk skip of the cumulative CUDA kernel.

Shared by ``test_torch_chunk_caps.py`` (the plain skip rule on the CPU)
and ``test_torch_cuda.py`` (the kernel on the card). No JAX import: the
card's machine has no JAX.

:func:`edge_case_inputs` packs tiles by hand (no Morton sort, so each case
sits in a chunk of its own) with these cases:

- a pair exactly on its row's largest threshold, between two chunks of two
  points each whose caps are tangent up to that threshold's chord: on the
  sphere, and on straight lines in chord space (four chunks of a tile, one
  bin each), where the caps are tangent in exact arithmetic;
- a chunk of zero-weight points lying on top of counted columns, a chunk
  of zero weights throughout, and zero-weight lanes far from their chunk's
  counted points;
- chunks far beyond every threshold, and random clusters with signed
  weights and mixed bins.

:func:`band_inputs` splits each bin's largest threshold of those cases
into a threshold and an audit band, so that the pair on it lies exactly at
``t + band`` or one float32 ulp beyond; :func:`near_pairs` is the audit's
per-pair test in the kernels' operations.
"""

import numpy as np
import torch

from yet_another_wizz_tpu_torch.ops.tiles import (
    CHANNEL_WEIGHT,
    CHANNEL_ZBIN,
    CHUNK_SIZE,
)

TILE_SIZE = 4 * CHUNK_SIZE
NUM_BINS = 6


def kernel_chord2(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``(P, T, T)`` float32 squared chords of tile pairs ``(P, 8, T)`` in
    the kernels' operations and order (compensated difference, no FMA)."""
    chord2 = None
    for dim in range(3):
        d = (rows[:, dim, :, None] - cols[:, None, dim, :]) + (
            rows[:, 3 + dim, :, None] - cols[:, None, 3 + dim, :]
        )
        chord2 = d * d if chord2 is None else chord2 + d * d
    return chord2


def counted_pairs(lanes1, lanes2, tile1, tile2, table, *, cols_binned):
    """``(P, T, T)`` bool: pairs of nonzero weights within their row's
    largest threshold (and, with binned columns, of equal bins)."""
    rows, cols = lanes1[tile1.long()], lanes2[tile2.long()]
    bins = rows[:, CHANNEL_ZBIN].long().clamp(0, table.shape[0] - 1)
    largest = table.amax(dim=1)[bins]  # (P, T)
    counted = kernel_chord2(rows, cols) <= largest[:, :, None]
    counted &= (rows[:, CHANNEL_WEIGHT] != 0)[:, :, None]
    counted &= (cols[:, CHANNEL_WEIGHT] != 0)[:, None, :]
    if cols_binned:
        counted &= rows[:, CHANNEL_ZBIN, :, None] == cols[:, None, CHANNEL_ZBIN, :]
    return counted


def block_counts(lanes1, lanes2, tile1, tile2, table, *, cols_binned,
                 pair_mask=None):
    """``(P, B, E)`` cumulative weighted counts of tile pairs, every pair
    evaluated with :func:`kernel_chord2`; a pair outside ``pair_mask``
    (``(P, T, T)`` bool) adds +0. The same operations in the same order
    with and without the mask."""
    rows, cols = lanes1[tile1.long()], lanes2[tile2.long()]
    num_bins = table.shape[0]
    bins = rows[:, CHANNEL_ZBIN].long().clamp(0, num_bins - 1)  # (P, T)
    zero = torch.zeros((), dtype=rows.dtype)
    w_cols = cols[:, CHANNEL_WEIGHT, None, :].expand(-1, rows.shape[2], -1)
    if cols_binned:
        same_bin = rows[:, CHANNEL_ZBIN, :, None] == cols[:, None, CHANNEL_ZBIN, :]
        w_cols = torch.where(same_bin, w_cols, zero)
    if pair_mask is not None:
        w_cols = torch.where(pair_mask, w_cols, zero)
    within = kernel_chord2(rows, cols)[..., None] <= table[bins][:, :, None, :]
    per_row = torch.where(within, w_cols[..., None], zero).sum(dim=2)  # (P, T, E)
    per_row = per_row * rows[:, CHANNEL_WEIGHT, :, None]
    one_hot = (bins[..., None] == torch.arange(num_bins)).to(rows.dtype)
    return torch.einsum("ptb,pte->pbe", one_hot, per_row)


def expand_chunks(keep: torch.Tensor) -> torch.Tensor:
    """A ``(P, K, K)`` chunk mask as the ``(P, T, T)`` pair mask."""
    return keep.repeat_interleave(CHUNK_SIZE, dim=1).repeat_interleave(
        CHUNK_SIZE, dim=2
    )


def unit_weights(lanes: torch.Tensor) -> torch.Tensor:
    """The lanes with weight 1 wherever it is nonzero (padding stays 0)."""
    lanes = lanes.clone()
    lanes[:, CHANNEL_WEIGHT] = (lanes[:, CHANNEL_WEIGHT] != 0).to(lanes.dtype)
    return lanes


def _arc(t, offset=0.0):
    """Points at arc length ``t`` along a great circle through (0.3, 0.4,
    ~0.87), ``offset`` radian off it."""
    u = np.array([0.3, 0.4, np.sqrt(1 - 0.25)])
    v = np.cross(u, [0.0, 0.0, 1.0])
    v /= np.linalg.norm(v)
    n = np.cross(u, v)
    t = np.atleast_1d(t)[:, None]
    offset = np.broadcast_to(np.atleast_1d(offset), t.shape[:1])[:, None]
    xyz = np.cos(t) * u + np.sin(t) * v + np.sin(offset) * n
    return xyz / np.linalg.norm(xyz, axis=1, keepdims=True)


def _pack(xyz, weights, bins):
    """One tile ``(8, T)`` of the given points, unsorted."""
    lanes = np.zeros((8, TILE_SIZE), np.float32)
    hi = xyz.astype(np.float32)
    lanes[0:3] = hi.T
    lanes[3:6] = (xyz - hi.astype(np.float64)).astype(np.float32).T
    lanes[CHANNEL_WEIGHT] = weights
    lanes[CHANNEL_ZBIN] = bins
    return lanes


def _chunk(xyz, weights, bins):
    return np.asarray(xyz), np.asarray(weights, float), np.asarray(bins, float)


def edge_case_inputs(seed: int, *, signed: bool):
    """``(lanes1, lanes2, tile1, tile2, table)`` on the CPU: three row
    tiles (binned) and three column tiles (binned too; they count as
    unbinned columns unless ``cols_binned``), the tile pairs (0, 0), (0,
    1), (1, 0), (1, 1) and (2, 2), and a ``(6, 3)`` table. Bin 0's largest
    threshold is exactly the kernel chord of the inner pair (row lane 1,
    column lane 0) of the tangent chunks on the sphere, bin 1's that of a
    pair of the random clusters, and bin ``2 + k``'s that of the inner pair
    of chunk ``k`` of tiles 2, tangent on a straight line."""
    rng = np.random.default_rng(seed)
    C = CHUNK_SIZE

    def weights(n):
        w = rng.uniform(0.5, 2.0, n)
        return w * rng.choice([-1.0, 1.0], n) if signed else w

    def cluster(t0, t1, n=C, spread=0.01):
        return _arc(rng.uniform(t0, t1, n), rng.uniform(-spread, spread, n))

    def two_points(t_a, t_b, far):
        """A chunk of two counted points; the rest weight 0, far away."""
        xyz = np.concatenate([_arc([t_a, t_b]), _arc(np.full(C - 2, far))])
        w = np.zeros(C)
        w[:2] = weights(2)
        return _chunk(xyz, w, np.zeros(C))

    rows_a = [
        two_points(0.0, 0.01, far=1.0),  # tangent with the column chunk
        _chunk(_arc(np.full(C, 0.02)), np.zeros(C), np.zeros(C)),  # padding
        _chunk(cluster(0.0, 0.05), weights(C), rng.integers(0, 2, C)),
        _chunk(cluster(0.45, 0.5), weights(C), rng.integers(0, 2, C)),  # far
    ]
    cols_a = [
        two_points(0.02, 0.03, far=-1.0),
        _chunk(cluster(0.0, 0.05), weights(C), rng.integers(0, 2, C)),
        _chunk(cluster(-0.6, -0.5), weights(C), rng.integers(0, 2, C)),
        _chunk(cluster(0.0, 0.05), np.zeros(C), np.zeros(C)),  # padding
    ]
    rows_b = [
        _chunk(cluster(0.01, 0.04, spread=0.003), weights(C), rng.integers(0, 2, C))
        for _ in range(4)
    ]
    cols_b = [
        _chunk(cluster(0.0, 0.06, spread=0.003), weights(C), rng.integers(0, 2, C))
        for _ in range(4)
    ]

    # tangent on straight lines: rows p, p + d u; columns p + 2 d u,
    # p + 3 d u; the rest of each chunk weight 0 at p
    rows_c, cols_c = [], []
    for k in range(4):
        p = _arc(rng.uniform(-0.3, 0.3))[0]
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        d = rng.uniform(0.001, 0.01)
        for chunks, steps in ((rows_c, (0, 1)), (cols_c, (2, 3))):
            xyz = np.tile(p, (C, 1))
            xyz[:2] += np.outer(np.array(steps) * d, u)
            w = np.zeros(C)
            w[:2] = weights(2)
            chunks.append(_chunk(xyz, w, np.full(C, 2 + k)))

    def tile(chunks):
        return _pack(*(np.concatenate(part) for part in zip(*chunks)))

    lanes1 = torch.from_numpy(np.stack([tile(rows_a), tile(rows_b), tile(rows_c)]))
    lanes2 = torch.from_numpy(np.stack([tile(cols_a), tile(cols_b), tile(cols_c)]))
    # bin 0's largest threshold: exactly the kernel chord of the inner pair
    # of the tangent chunks (row lane 1, column lane 0)
    exact = kernel_chord2(lanes1[:1], lanes2[:1])[0, 1, 0].item()
    # bin 1's: exactly the chord of a pair of the random clusters
    chord2 = kernel_chord2(lanes1[1:], lanes2[1:])[0]
    in_bin1 = (lanes1[1, CHANNEL_ZBIN] == 1).nonzero()[0, 0]
    exact1 = torch.sort(chord2[in_bin1]).values[C].item()
    chord2 = kernel_chord2(lanes1[2:], lanes2[2:])[0]
    line = [chord2[k * C + 1, k * C].item() for k in range(4)]
    table = torch.tensor(
        [[exact / 16, exact / 4, exact], [exact1 / 4, exact1, exact1 / 2]]
        + [[t / 4, t, t / 2] for t in line],
        dtype=torch.float32,
    )
    assert table[0, 2].item() == exact and table[1, 1].item() == exact1
    assert table[2:, 1].tolist() == line
    tile1 = torch.tensor([0, 0, 1, 1, 2], dtype=torch.int32)
    tile2 = torch.tensor([0, 1, 0, 1, 2], dtype=torch.int32)
    return lanes1, lanes2, tile1, tile2, table


def near_pairs(lanes1, lanes2, tile1, tile2, table, band, *, cols_binned):
    """``(P, T, T)`` bool: valid pairs (nonzero weights; with binned
    columns, equal bins) with ``|chord2 - t| <= band`` for an edge of their
    row's bin, the chord in the kernels' operations and order."""
    rows, cols = lanes1[tile1.long()], lanes2[tile2.long()]
    bins = rows[:, CHANNEL_ZBIN].long().clamp(0, table.shape[0] - 1)  # (P, T)
    chord2 = kernel_chord2(rows, cols)[..., None]  # (P, T, T, 1)
    near = ((chord2 - table[bins][:, :, None]).abs() <= band[bins][:, :, None])
    near = near.any(dim=3)
    near &= (rows[:, CHANNEL_WEIGHT] != 0)[:, :, None]
    near &= (cols[:, CHANNEL_WEIGHT] != 0)[:, None, :]
    if cols_binned:
        near &= rows[:, CHANNEL_ZBIN, :, None] == cols[:, None, CHANNEL_ZBIN, :]
    return near


ON_BAND = [(0, 1, 0)] + [(4, CHUNK_SIZE * k + 1, CHUNK_SIZE * k) for k in range(4)]
"""``(tile pair, row, column)`` of the pairs exactly on a bin's largest
threshold in :func:`edge_case_inputs` whose caps are tangent (bins 0 and 2
to 5): :func:`band_inputs` puts them at ``t + band``."""


def band_inputs(table: torch.Tensor, *, beyond: bool):
    """``(table, band)`` float32 from an :func:`edge_case_inputs` table:
    each bin's largest threshold ``t*`` (the exact kernel chord of a pair)
    becomes ``t = t* - band`` with ``band`` near ``t* / 8``, a multiple
    of the float32 spacing of ``t*``, so that ``t + band`` and ``t* - t``
    are exact: the pair lies exactly at ``t + band``. With ``beyond`` the
    band is one spacing smaller, so the pair lies one float32 ulp beyond
    ``t + band``. The other thresholds keep a band of ``2e-6 t``. A band
this wide moves the reach by far more than the caps' slack, so a skip that
left the band out would drop the pair."""
    t_star, e_star = table.max(dim=1)
    spacing = torch.from_numpy(np.spacing(t_star.numpy()))
    wide = torch.round(t_star / 8 / spacing) * spacing
    band = (table * 2e-6).clone()
    out = table.clone()
    rows = torch.arange(len(table))
    out[rows, e_star] = t_star - wide
    band[rows, e_star] = wide - spacing if beyond else wide
    # exact in float32: the pair's chord minus t is the band (or one
    # spacing above it), and t + band is t* (or the float below it)
    assert torch.equal(t_star - out[rows, e_star], wide)
    assert torch.equal(out[rows, e_star] + band[rows, e_star],
                       t_star - spacing if beyond else t_star)
    return out, band
