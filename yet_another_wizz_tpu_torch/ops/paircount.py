"""The tiled brute-force pair-count engine.

Replaces the reference's dual-tree kd-tree kernel
(yaw/catalog/trees.py:303-362) with dense tile-pair arithmetic, as the JAX
package does:

- for a pair of point tiles, squared chord distances are evaluated from
  (hi, lo)-split float32 coordinates — the compensated difference keeps
  relative precision ~1e-7 even at arcsecond separations, far below plain
  float32 resolution (a plain ``1 - dot`` formulation is useless below
  ~1e-3 rad);
- pairs are counted cumulatively against per-redshift-bin squared-chord
  thresholds, selected per row by an exact gather on the row's bin id;
- per-pair ``(bin, edge)`` blocks are summed into a ``(patch-pair slot,
  bin, edge)`` tensor; host-side float64 post-processing converts
  cumulative edges into per-scale counts.

Execution paths of :func:`count_pairs_tiles`:

- ``cuda``: the hand-written CUDA kernels of
  :mod:`yet_another_wizz_tpu_torch.ops.cuda_paircount`, for tile tensors
  on a CUDA device; ``auto`` goes through the same wrapper, which takes
  the plain version below for tensors on the CPU;
- ``torch``: the plain PyTorch engine (:func:`count_pairs_torch`), a
  batched port of the JAX package's ``pair_block_counts`` +
  ``scan_scatter_counts``; the CPU tests use it, and the chip smoke run
  holds the kernels against it;
- ``oracle``: float64 scipy kd-trees on the host, for validation.

With ``audit=True`` the counts pass through :func:`audit_boundary_counts`:
a flag pass on the device (:func:`boundary_flags`: the CUDA flag kernel on
the card, its plain version :func:`boundary_flags_torch` on the CPU, both
in the kernels' chord arithmetic) marks every tile pair holding a pair
within float32 resolution of a threshold of its bin, and the flagged
patch-pair slots are recounted in float64 by the oracle.
"""

from __future__ import annotations

import collections
import functools
import logging
from typing import TYPE_CHECKING

import numpy as np
import torch

from yet_another_wizz_tpu_torch.coordinates import angle_to_chord
from yet_another_wizz_tpu_torch.ops.gweight import (
    apply_direct_weight,
    counting_width,
)
from yet_another_wizz_tpu_torch.ops.tiles import (
    CHANNEL_WEIGHT,
    CHANNEL_ZBIN,
    CHUNK_SIZE,
)
from yet_another_wizz_tpu_torch.utils.tracing import count, span

if TYPE_CHECKING:
    from numpy.typing import NDArray

    from yet_another_wizz_tpu_torch.ops.linkage import TilePairs
    from yet_another_wizz_tpu_torch.ops.tiles import TileSet

logger = logging.getLogger(__name__)

__all__ = [
    "AUDIT_RESIDENT_BYTES",
    "AUDIT_STATS",
    "audit_band",
    "audit_boundary_counts",
    "boundary_flags",
    "boundary_flags_torch",
    "chunk_keep_mask",
    "chunk_reach",
    "count_pairs_tiles",
    "count_pairs_torch",
    "flag_work_items",
    "pair_block_boundary",
    "pair_block_counts",
    "partial_counts_torch",
    "reset_audit_stats",
    "resolve_device",
    "segment_sum_torch",
]

DEFAULT_CHUNK_SIZE = 8
"""Tile pairs per batch of the plain engine. Each batch holds a few
``(chunk, T, T)`` float32 temporaries (1 MiB per tile pair at T = 512)."""


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a :class:`torch.device`; raises for a CUDA device when
    CUDA is not available (nothing falls back to the CPU silently)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch engine"
        )
    return device


def _chord2(rows: torch.Tensor, lanes2: torch.Tensor) -> torch.Tensor:
    """``(K, T, T)`` float32 squared chords between the rows ``(K, T, 8)``
    and the column tiles ``(K, 8, T)``: the compensated difference ``(r_hi -
    c_hi) + (r_lo - c_lo)`` per axis, squared and summed in axis order, each
    step a separate float32 operation (as in the CUDA kernels, which are
    built without FMA contraction)."""
    chord2 = None
    for dim in range(3):
        d_hi = rows[:, :, dim, None] - lanes2[:, None, dim, :]
        d_lo = rows[:, :, 3 + dim, None] - lanes2[:, None, 3 + dim, :]
        d = d_hi + d_lo
        chord2 = d * d if chord2 is None else chord2 + d * d
    return chord2


def pair_block_counts(
    lanes1: torch.Tensor,
    lanes2: torch.Tensor,
    chord2_table: torch.Tensor,
    *,
    cols_binned: bool = False,
    direct: tuple | None = None,
) -> torch.Tensor:
    """Cumulative weighted pair counts between batches of tile pairs.

    Args:
        lanes1: ``(K, 8, T)`` float32 row tiles (the redshift-binned
            catalog); channel layout as in :mod:`.tiles`.
        lanes2: ``(K, 8, T)`` float32 column tiles.
        chord2_table: ``(B, E)`` float32 squared-chord thresholds per bin.
            In direct mode the table carries the per-bin weight parameter
            block appended after the counting edges (see
            :meth:`yet_another_wizz_tpu_torch.ops.thresholds.DirectEdges.combined_table`).
        cols_binned: require equal bin indices on both sides (both catalogs
            binned, i.e. autocorrelation-style counting).
        direct: ``(num_sub, num_below, num_above[, small_angle])``
            configuration of the direct separation-weighted counting mode,
            or None.

    Returns:
        ``(K, B, E)`` float32; entry (k, b, e) is the sum of ``w_i * w_j``
        over pairs of tile pair k with row point in bin b and squared
        chord ``<= chord2_table[b, e]`` (times the per-pair separation
        weight in direct mode).

    Every elementwise step is a separate float32 operation, so the
    arithmetic rounds exactly as the CUDA kernel's (which is built without
    FMA contraction); only the order of the float32 sums differs.
    """
    num_bins = chord2_table.shape[0]
    num_edges = counting_width(chord2_table.shape[1], direct)
    rows = lanes1.transpose(1, 2)  # (K, T, 8)
    chord2 = _chord2(rows, lanes2)

    # per-row thresholds (and weight parameters): an exact gather by the
    # row's bin id (padding rows carry bin 0 and weight 0)
    bin_ids = rows[:, :, 7].long().clamp_(0, num_bins - 1)  # (K, T)
    selected = chord2_table[bin_ids]  # (K, T, E [+ C])
    thresholds = selected[:, :, :num_edges]

    zero = torch.zeros((), dtype=chord2.dtype, device=chord2.device)
    w_cols = lanes2[:, None, 6, :]  # (K, 1, T)
    if cols_binned:
        # exact compare of the float bin lanes
        same_bin = rows[:, :, 7, None] == lanes2[:, None, 7, :]  # (K, T, T)
        w_cols = torch.where(same_bin, w_cols, zero)
    if direct is not None:
        w_cols = apply_direct_weight(
            chord2, selected[:, :, num_edges:],
            w_cols.expand(chord2.shape),
            num_sub=direct[0], num_below=direct[1], num_above=direct[2],
            small_angle=len(direct) > 3 and bool(direct[3]),
        )

    row_counts = torch.stack(
        [
            torch.where(chord2 <= thresholds[:, :, e, None], w_cols, zero).sum(
                dim=2
            )
            for e in range(num_edges)
        ],
        dim=2,
    )  # (K, T, E)

    # reduce rows into bins weighted by the row weights: an explicit
    # float32 sum (no matmul, so no TF32 question)
    weighted = rows[:, :, 6, None] * row_counts  # (K, T, E)
    onehot = bin_ids[:, :, None] == torch.arange(
        num_bins, device=bin_ids.device
    )  # (K, T, B)
    return torch.where(
        onehot[:, :, :, None], weighted[:, :, None, :], zero
    ).sum(dim=1)  # (K, B, E)


def partial_counts_torch(
    lanes1: torch.Tensor,
    lanes2: torch.Tensor,
    tile1: torch.Tensor,
    tile2: torch.Tensor,
    chord2_table: torch.Tensor,
    *,
    cols_binned: bool = False,
    direct: tuple | None = None,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
) -> torch.Tensor:
    """``(P, B, E)`` float32 block of every tile pair ``(tile1[k],
    tile2[k])``: the plain version of the CUDA partials kernel. Works in
    batches of ``chunk_size`` tile pairs to bound the temporaries."""
    num_bins = chord2_table.shape[0]
    num_edges = counting_width(chord2_table.shape[1], direct)
    partial = torch.empty(
        (len(tile1), num_bins, num_edges),
        dtype=torch.float32, device=lanes1.device,
    )
    for start in range(0, len(tile1), chunk_size):
        stop = start + chunk_size
        partial[start:stop] = pair_block_counts(
            lanes1[tile1[start:stop]], lanes2[tile2[start:stop]], chord2_table,
            cols_binned=cols_binned, direct=direct,
        )
    return partial


def chunk_reach(
    lanes1: torch.Tensor,
    caps1: torch.Tensor,
    chord2_table: torch.Tensor,
    band_table: torch.Tensor | None = None,
) -> torch.Tensor:
    """``(N1, K)`` float32, ``K = T / 32``: how far each row chunk reaches
    in chord, ``sqrt(m) + r_row`` with ``m`` the largest threshold of its
    rows of nonzero weight (``-inf`` for a chunk without such rows), in the
    kernels' float32 operations. ``caps1`` are the row tiles'
    :func:`~yet_another_wizz_tpu_torch.ops.tiles.chunk_caps`,
    ``chord2_table`` one launch's edges; with ``band_table`` each threshold
    is widened to ``t + band`` (a float32 sum), the flag kernel's reach
    (``csrc/paircount.cu``, ``flag_reach_kernel``)."""
    num_tiles, _, tile_size = lanes1.shape
    bins = lanes1[:, CHANNEL_ZBIN].long().clamp(0, chord2_table.shape[0] - 1)
    if band_table is not None:
        chord2_table = chord2_table + band_table
    largest = chord2_table.amax(dim=1)[bins]  # (N1, T)
    largest = torch.where(lanes1[:, CHANNEL_WEIGHT] != 0, largest, -1.0)
    largest = largest.view(num_tiles, tile_size // CHUNK_SIZE, CHUNK_SIZE)
    largest = largest.amax(dim=2)  # (N1, K)
    return torch.where(
        largest < 0, float("-inf"), largest.clamp(min=0).sqrt() + caps1[..., 3]
    )


def chunk_keep_mask(
    lanes1: torch.Tensor,
    caps1: torch.Tensor,
    caps2: torch.Tensor,
    tile1: torch.Tensor,
    tile2: torch.Tensor,
    chord2_table: torch.Tensor,
    *,
    cols_binned: bool = False,
    band_table: torch.Tensor | None = None,
) -> torch.Tensor:
    """``(P, K, K)`` bool, ``K = T / 32``: the (row chunk, column chunk)
    blocks of each tile pair that the cumulative CUDA kernel evaluates, in
    the kernel's float32 operations and order (``csrc/paircount.cu``,
    ``chunk_reaches``). ``lanes1`` are the row tiles, ``caps*`` the
    tile sets' :func:`~yet_another_wizz_tpu_torch.ops.tiles.chunk_caps`,
    ``chord2_table`` one launch's edges. A row chunk reaches as far
    as :func:`chunk_reach`; a block is dropped when the caps lie farther
    apart than the radii plus that chord or, with binned columns, when
    their bin ranges are disjoint. With ``band_table`` (``(B, E)``
    float32) each threshold is widened to ``t + band``, the reach of the
    flag kernel's triage. The plain engine (:func:`pair_block_counts`) and
    the plain flag pass evaluate every pair; this mirror serves the tests
    and the chip smoke run's kept share."""
    tile1, tile2 = tile1.long(), tile2.long()
    reach = chunk_reach(lanes1, caps1, chord2_table, band_table)
    row_caps = caps1[tile1][:, :, None, :]  # (P, K, 1, 8)
    col_caps = caps2[tile2][:, None, :, :]  # (P, 1, K, 8)
    limit = reach[tile1][:, :, None] + col_caps[..., 3]
    d = row_caps[..., :3] - col_caps[..., :3]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    keep = (limit >= 0) & (d2 <= limit * limit)
    if cols_binned:
        disjoint = (row_caps[..., 5] < col_caps[..., 4]) | (
            col_caps[..., 5] < row_caps[..., 4]
        )
        keep &= ~disjoint
    return keep


FLAG_ITEM_CHUNKS = 16
"""Column chunks one work item of the flag kernel covers (its mask's
bits)."""


def flag_work_items(
    lanes1: torch.Tensor,
    caps1: torch.Tensor,
    caps2: torch.Tensor,
    tile1: torch.Tensor,
    tile2: torch.Tensor,
    chord2_table: torch.Tensor,
    band_table: torch.Tensor,
    *,
    cols_binned: bool = False,
    flags: torch.Tensor | None = None,
) -> torch.Tensor:
    """``(M, 3)`` int64 ``(entry, unit, mask)``: the work list of the flag
    kernel's triage (``csrc/paircount.cu``, ``flag_triage_kernel``), its
    plain mirror, sorted. The blocks that :func:`chunk_keep_mask` keeps
    with ``band_table`` are grouped by row chunk ``r`` and by runs of
    :data:`FLAG_ITEM_CHUNKS` column chunks ``g``: an item for each
    ``(entry, r, g)`` that keeps any, with ``unit = r * G + g`` (``G`` runs
    per row chunk) and bit ``i`` of ``mask`` for column chunk ``g *``
    :data:`FLAG_ITEM_CHUNKS` ``+ i``. Entries set in ``flags`` (``(P,)``
    bool, flagged by an earlier group of edges) get none. An entry without
    items has flag 0: none of its pairs is evaluated."""
    keep = chunk_keep_mask(
        lanes1, caps1, caps2, tile1, tile2, chord2_table,
        cols_binned=cols_binned, band_table=band_table,
    )
    if flags is not None:
        keep &= ~flags[:, None, None]
    num_pairs, num_chunks, _ = keep.shape
    runs = -(-num_chunks // FLAG_ITEM_CHUNKS)
    keep = torch.nn.functional.pad(keep, (0, runs * FLAG_ITEM_CHUNKS - num_chunks))
    keep = keep.view(num_pairs, num_chunks, runs, FLAG_ITEM_CHUNKS)
    bits = 1 << torch.arange(FLAG_ITEM_CHUNKS, device=keep.device)
    mask = (keep.long() * bits).sum(dim=3)  # (P, K, G)
    entry, row, run = mask.nonzero(as_tuple=True)
    return torch.stack([entry, row * runs + run, mask[entry, row, run]], dim=1)


def segment_sum_torch(
    partial: torch.Tensor, slot: torch.Tensor, num_slots: int
) -> torch.Tensor:
    """Sum the per-pair blocks into their patch-pair slots, ``(num_slots,
    B, E)`` float32: the plain version of the CUDA segment-sum kernel.
    Slots without entries stay zero. On the CPU ``index_add_`` adds in list
    order, so the result is deterministic there."""
    out = torch.zeros(
        (num_slots, *partial.shape[1:]), dtype=partial.dtype,
        device=partial.device,
    )
    return out.index_add_(0, slot.long(), partial)


def count_pairs_torch(
    lanes1: torch.Tensor,
    lanes2: torch.Tensor,
    pairs: TilePairs,
    chord2_table: torch.Tensor,
    *,
    cols_binned: bool = False,
    direct: tuple | None = None,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
) -> torch.Tensor:
    """The plain PyTorch engine: ``(num_slots, B, E)`` float32 cumulative
    counts per patch-pair slot, on the device of the lanes. Counts as
    :func:`~yet_another_wizz_tpu_torch.ops.cuda_paircount.count_pairs_cuda`
    does (``engine.tile_pairs``, ``engine.candidate_pairs``)."""
    device = lanes1.device
    num_pairs = int(pairs.num_pairs)
    count("engine.tile_pairs", num_pairs)
    count("engine.candidate_pairs", num_pairs * lanes1.shape[2] * lanes2.shape[2])
    tile1 = torch.from_numpy(np.asarray(pairs.tile1, np.int64)).to(device)
    tile2 = torch.from_numpy(np.asarray(pairs.tile2, np.int64)).to(device)
    slot = torch.from_numpy(np.asarray(pairs.slot, np.int64)).to(device)
    partial = partial_counts_torch(
        lanes1, lanes2, tile1, tile2, chord2_table,
        cols_binned=cols_binned, direct=direct, chunk_size=chunk_size,
    )
    return segment_sum_torch(partial, slot, pairs.num_slots)


AUDIT_RESIDENT_BYTES = 2 << 30
"""Combined lane bytes above which the audit's flag pass streams
host-gathered windows of tile pairs to the device (about
:data:`AUDIT_WINDOW_BYTES` each) instead of reading both full tile sets
there (the JAX package's bound)."""

AUDIT_WINDOW_BYTES = 256 << 20
"""Gathered lane bytes per window of the streaming flag pass."""

AUDIT_CHUNK_SIZE = 64
"""Tile pairs per batch of the plain flag pass (:func:`boundary_flags_torch`):
a few ``(64, T, T)`` temporaries, 64 MiB each in float32 at T = 512. The
JAX package batches 16."""

AUDIT_STATS_KEPT = 1024
"""Records :data:`AUDIT_STATS` keeps: the newest ones."""

AUDIT_STATS: collections.deque[dict] = collections.deque(maxlen=AUDIT_STATS_KEPT)
"""One record per call of :func:`audit_boundary_counts` in this process,
the newest :data:`AUDIT_STATS_KEPT` (diagnostic; cleared by
:func:`reset_audit_stats`): ``flagged_slots`` (int64 array of the
recounted slot indices) and ``recount_workers``. The flag pass and the
recount are the spans ``audit.flag`` and ``audit.recount``
(:mod:`~yet_another_wizz_tpu_torch.utils.tracing`)."""


def reset_audit_stats() -> None:
    """Clear :data:`AUDIT_STATS`."""
    AUDIT_STATS.clear()


def audit_band(
    edges_radian: NDArray, chord2_table: NDArray, rel_band: float = 1e-6
) -> NDArray:
    """float64 ``(B, E)`` half-width of the band around each threshold in
    which the float32 engine may classify a pair differently from the
    float64 oracle: the engine's relative chord error plus the float32
    rounding of the threshold itself, with a 2x margin.

    The JAX package widens the band further by the fixed-point lane
    quantisation (``lane_quantisation_scale``); that term is zero for
    float32 lanes, the only lanes of this package."""
    t64 = angle_to_chord(np.asarray(edges_radian, dtype=np.float64)) ** 2
    t32 = np.asarray(chord2_table, dtype=np.float64)
    return 2.0 * (rel_band * t64 + np.abs(t32 - t64))


def pair_block_boundary(
    lanes1: torch.Tensor,
    lanes2: torch.Tensor,
    chord2_table: torch.Tensor,
    band_table: torch.Tensor,
    *,
    cols_binned: bool = False,
) -> torch.Tensor:
    """``(K,)`` bool: does any valid pair of tile pair ``k`` (rows
    ``lanes1[k]``, columns ``lanes2[k]``, ``(K, 8, T)`` float32) lie within
    the band of a threshold of its row's bin, ``|chord2 - t| <= band``?

    The JAX package's ``_pair_block_boundary``, batched: the chord is the
    engine's (:func:`_chord2`); a pair is valid where both weights are
    nonzero (zero marks padding, negative weights are real data) and, with
    ``cols_binned``, the bins are equal; each row reads the thresholds and
    bands of its own bin by an exact gather."""
    num_bins, num_edges = chord2_table.shape
    rows = lanes1.transpose(1, 2)  # (K, T, 8)
    chord2 = _chord2(rows, lanes2)
    bin_ids = rows[:, :, CHANNEL_ZBIN].long().clamp_(0, num_bins - 1)
    thresholds = chord2_table[bin_ids]  # (K, T, E)
    bands = band_table[bin_ids]
    valid = (rows[:, :, CHANNEL_WEIGHT, None] != 0) & (
        lanes2[:, None, CHANNEL_WEIGHT, :] != 0
    )
    if cols_binned:
        valid &= rows[:, :, CHANNEL_ZBIN, None] == lanes2[:, None, CHANNEL_ZBIN, :]
    hit = torch.zeros_like(valid)
    for e in range(num_edges):
        hit |= (chord2 - thresholds[:, :, e, None]).abs() <= bands[:, :, e, None]
    return (hit & valid).flatten(1).any(dim=1)


def boundary_flags_torch(
    lanes1: torch.Tensor,
    lanes2: torch.Tensor,
    tile1: torch.Tensor,
    tile2: torch.Tensor,
    chord2_table: torch.Tensor,
    band_table: torch.Tensor,
    *,
    cols_binned: bool = False,
    chunk_size: int = AUDIT_CHUNK_SIZE,
) -> torch.Tensor:
    """``(P,)`` bool on the lanes' device: :func:`pair_block_boundary` of
    every tile pair ``(tile1[k], tile2[k])``, in batches of ``chunk_size``
    tile pairs (the JAX package's ``_boundary_flags_xla``): the plain
    version of the CUDA flag kernel, which evaluates every pair."""
    flags = torch.empty(len(tile1), dtype=torch.bool, device=lanes1.device)
    for start in range(0, len(tile1), chunk_size):
        stop = start + chunk_size
        flags[start:stop] = pair_block_boundary(
            lanes1[tile1[start:stop]], lanes2[tile2[start:stop]],
            chord2_table, band_table, cols_binned=cols_binned,
        )
    return flags


def boundary_flags(
    lanes1: torch.Tensor,
    lanes2: torch.Tensor,
    tile1: torch.Tensor,
    tile2: torch.Tensor,
    chord2_table: torch.Tensor,
    band_table: torch.Tensor,
    *,
    cols_binned: bool = False,
    chunk_size: int = AUDIT_CHUNK_SIZE,
) -> torch.Tensor:
    """``(P,)`` bool on the lanes' device: the flag of every tile pair
    ``(tile1[k], tile2[k])``. CPU tensors take the plain version
    (:func:`boundary_flags_torch`, in batches of ``chunk_size``), CUDA
    tensors the flag kernel
    (:func:`~yet_another_wizz_tpu_torch.ops.cuda_paircount.boundary_flags_cuda`,
    int32 indices); any other device raises."""
    if lanes1.device.type == "cpu":
        return boundary_flags_torch(
            lanes1, lanes2, tile1.long(), tile2.long(), chord2_table,
            band_table, cols_binned=cols_binned, chunk_size=chunk_size,
        )
    if lanes1.device.type != "cuda":
        raise ValueError(f"no flag pass for device {lanes1.device}")
    from yet_another_wizz_tpu_torch.ops.cuda_paircount import (
        boundary_flags_cuda,
    )

    return boundary_flags_cuda(
        lanes1, lanes2, tile1, tile2, chord2_table, band_table,
        cols_binned=cols_binned,
    )


def _flag_pass(tiles1, tiles2, pairs, table, band, device, chunk_size):
    """The flags of every tile pair of ``pairs``, as numpy bool. Tile sets
    up to :data:`AUDIT_RESIDENT_BYTES` are read from their uploaded lanes
    by the pair list's cached int32 indices; larger ones stream windows of
    host-gathered lanes (the JAX package's ``_boundary_flags_gathered``),
    indexed by the window's ``arange``, so the device holds about
    :data:`AUDIT_WINDOW_BYTES` of lanes (and their chunk caps, on the card)
    at a time."""
    from yet_another_wizz_tpu_torch.ops.cuda_paircount import _pair_index

    cols_binned = tiles2.binned
    if tiles1.lane_data.nbytes + tiles2.lane_data.nbytes <= AUDIT_RESIDENT_BYTES:
        index = _pair_index(pairs, device)
        return boundary_flags(
            tiles1.device_data(device), tiles2.device_data(device),
            index.tile1, index.tile2, table, band,
            cols_binned=cols_binned, chunk_size=chunk_size,
        ).cpu().numpy()
    per_pair = tiles1.lane_data[0].nbytes + tiles2.lane_data[0].nbytes
    window = max(
        chunk_size, AUDIT_WINDOW_BYTES // per_pair // chunk_size * chunk_size
    )
    flags = np.empty(pairs.num_pairs, dtype=bool)
    for start in range(0, pairs.num_pairs, window):
        stop = min(start + window, pairs.num_pairs)
        lanes1 = torch.from_numpy(tiles1.lane_data[pairs.tile1[start:stop]])
        lanes2 = torch.from_numpy(tiles2.lane_data[pairs.tile2[start:stop]])
        local = torch.arange(stop - start, dtype=torch.int32, device=device)
        flags[start:stop] = boundary_flags(
            lanes1.to(device), lanes2.to(device), local, local, table, band,
            cols_binned=cols_binned, chunk_size=chunk_size,
        ).cpu().numpy()
    return flags


def audit_boundary_counts(
    tiles1: TileSet,
    tiles2: TileSet,
    pairs: TilePairs,
    counts: NDArray,
    chord2_table: NDArray,
    edges_radian: NDArray,
    *,
    device: torch.device | str = "cuda",
    rel_band: float = 1e-6,
    chunk_size: int = AUDIT_CHUNK_SIZE,
) -> tuple[NDArray, int]:
    """Exact-boundary audit: certify or repair the float32 classification
    of pairs against the bin edges (the JAX package's
    ``audit_boundary_counts``).

    The engine compares float32 squared chords with float32 thresholds; a
    pair whose true separation lies within float32 resolution of an edge
    can land on the other side than in the float64 reference, moving one
    pair weight between bins. The flag pass (on ``device``) marks every
    tile pair holding a valid pair within :func:`audit_band` of a threshold
    of its row's bin, and the patch-pair slots of the flagged tile pairs
    are recounted with the float64 oracle from the tile sets' own points.

    ``counts`` are the engine's ``(num_slots, B, E)`` cumulative counts.
    Returns ``(corrected, num_flagged_slots)``: float64 counts with the
    flagged slots replaced by the oracle's. With no flagged slot the counts
    are returned as they are, certified free of misclassification. The
    recount runs on one thread, or on ``host_thread_count()`` threads (the
    measurement's ``max_workers``) with each slot counted whole by one of
    them, so both give the same bits."""
    from yet_another_wizz_tpu_torch.ops.cpu_oracle import count_pairs_oracle
    from yet_another_wizz_tpu_torch.utils.misc import host_thread_count

    if pairs.num_pairs == 0:
        return counts, 0
    device = resolve_device(device)
    band = audit_band(edges_radian, chord2_table, rel_band)
    band_table = torch.from_numpy(band.astype(np.float32)).to(device)
    table = torch.from_numpy(
        np.ascontiguousarray(chord2_table, np.float32)
    ).to(device)

    with span("audit.flag"):
        flags = _flag_pass(
            tiles1, tiles2, pairs, table, band_table, device, chunk_size
        )

    flagged_slots = np.unique(np.asarray(pairs.slot)[flags])
    workers = 0
    if len(flagged_slots):
        xyz1, w1, z1, p1 = _unpack_tileset(tiles1)
        xyz2, w2, z2, p2 = _unpack_tileset(tiles2)
        args = (
            xyz1, w1, z1, p1, xyz2, w2, z2 if tiles2.binned else None, p2,
            pairs.slot_patches[flagged_slots],
            np.asarray(edges_radian, dtype=np.float64),
        )
        workers = min(host_thread_count(default=1), len(flagged_slots))
        with span("audit.recount"):
            oracle = count_pairs_oracle(*args, max_workers=workers)
        counts = np.array(counts, dtype=np.float64, copy=True)
        counts[flagged_slots] = oracle
        logger.info(
            "boundary audit: %d patch-pair slot(s) recomputed in float64",
            len(flagged_slots),
        )
    AUDIT_STATS.append(dict(
        flagged_slots=flagged_slots.astype(np.int64), recount_workers=workers,
    ))
    return counts, int(len(flagged_slots))


def _unpack_tileset(tiles: TileSet):
    """Recover per-point float64 arrays from a tile set (hi + lo restores
    the original coordinates to ~1e-15; padding rows carry zero weight)."""
    data = tiles.lane_data.astype(np.float64)
    xyz = (data[:, 0:3, :] + data[:, 3:6, :]).transpose(0, 2, 1).reshape(-1, 3)
    weights = data[:, 6, :].reshape(-1)
    zbins = data[:, 7, :].reshape(-1).astype(int)
    patches = np.repeat(tiles.tile_patch, tiles.tile_size)
    keep = weights != 0.0
    return xyz[keep], weights[keep], zbins[keep], patches[keep]


def _count_pairs_oracle_backend(tiles1, tiles2, pairs, edges_radian):
    from yet_another_wizz_tpu_torch.ops.cpu_oracle import count_pairs_oracle

    xyz1, w1, z1, p1 = _unpack_tileset(tiles1)
    xyz2, w2, z2, p2 = _unpack_tileset(tiles2)
    return count_pairs_oracle(
        xyz1, w1, z1, p1,
        xyz2, w2, (z2 if tiles2.binned else None), p2,
        pairs.slot_patches, np.asarray(edges_radian, dtype=np.float64),
    )


@functools.lru_cache(maxsize=16)
def _device_table(
    data: bytes, shape: tuple[int, ...], device: torch.device
) -> torch.Tensor:
    """A float32 threshold table on ``device``, uploaded once per content:
    repeated counts with one configuration share the tensor, and with it
    the kernels' entry layout derived from it. Callers do not modify it."""
    count("cache.miss.table")
    table = np.frombuffer(data, np.float32).reshape(shape)
    return torch.from_numpy(table.copy()).to(device)


def count_pairs_tiles(
    tiles1: TileSet,
    tiles2: TileSet,
    pairs: TilePairs,
    chord2_table: NDArray,
    *,
    backend: str = "auto",
    device: torch.device | str = "cuda",
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    edges_radian: NDArray | None = None,
    audit: bool = False,
    mesh=None,
    data_sharding: str = "replicated",
    defer: bool = False,
    direct: tuple | None = None,
) -> NDArray | torch.Tensor:
    """Run the pair-count engine over a tile-pair list.

    Returns a float64 numpy array ``(num_slots, B, E)`` of cumulative
    weighted pair counts per patch-pair slot. With ``defer=True`` the
    float32 tensor is returned as soon as the work is queued on
    ``device``; the caller copies it to the host later.

    Backends: ``auto`` (the CUDA kernel wrapper, which runs the kernels on
    a CUDA device and their plain versions on the CPU), ``cuda`` (the
    kernels; raises unless ``device`` is a CUDA device), ``torch`` (the
    plain PyTorch engine on ``device``), ``oracle`` (float64 scipy
    kd-trees on the host, requires ``edges_radian``).

    A binned second tile set counts equal-bin pairs only
    (autocorrelation-style counting). With ``direct`` (a ``(num_sub,
    num_below, num_above[, small_angle])`` tuple) the engine runs the
    direct separation-weighted counting mode: ``chord2_table`` must then
    be the combined counting+parameter table
    (:meth:`yet_another_wizz_tpu_torch.ops.thresholds.DirectEdges.combined_table`)
    and the output edge axis covers only the counting edges. It is not
    available with ``audit`` or the ``oracle`` backend, which require the
    union-edge cumulative representation (callers fall back to it).

    With ``audit=True`` (requires ``edges_radian``) the counts pass through
    :func:`audit_boundary_counts`, which repairs any float32 bin-edge
    misclassification against the float64 reference; the result is then
    always the float64 numpy array (``defer`` has no effect).

    ``mesh`` selects the devices: ``"single"`` pins ``device``; None takes
    :func:`~yet_another_wizz_tpu_torch.parallel.auto_mesh` of ``device``
    (single-device unless several cards, ``YAWT_NUM_DEVICES`` or a
    multi-process job ask for a mesh); a
    :class:`~yet_another_wizz_tpu_torch.parallel.sharded.Mesh` counts
    sharded in the layout ``data_sharding``
    (:func:`~yet_another_wizz_tpu_torch.parallel.count_pairs_sharded`),
    and its first device of this process runs the audit. The ``oracle``
    backend ignores it.
    """
    if audit and edges_radian is None:
        raise ValueError("audit=True requires 'edges_radian'")
    if direct is not None and (audit or backend == "oracle"):
        raise ValueError(
            "direct counting requires the cumulative representation for "
            "audit/oracle execution"
        )
    cols_binned = tiles2.binned
    if cols_binned and tiles1.num_bins != tiles2.num_bins:
        raise ValueError("tile sets have inconsistent binning")
    if not tiles1.binned:
        raise ValueError("first tile set must be binned")
    if backend not in ("auto", "cuda", "torch", "oracle"):
        raise ValueError(f"unknown backend '{backend}'")

    if backend == "oracle":
        if edges_radian is None:
            raise ValueError("the 'oracle' backend requires 'edges_radian'")
        return _count_pairs_oracle_backend(tiles1, tiles2, pairs, edges_radian)

    from yet_another_wizz_tpu_torch.parallel.sharded import (
        count_pairs_sharded,
        resolve_mesh,
    )

    device = resolve_device(device)
    mesh = resolve_mesh(mesh, device)
    if mesh is not None:
        counts = count_pairs_sharded(
            tiles1, tiles2, pairs, chord2_table, mesh=mesh,
            data_sharding=data_sharding, backend=backend,
            defer=defer and not audit, direct=direct,
        )
        if audit:
            local = mesh.local_shards()
            counts, _ = audit_boundary_counts(
                tiles1, tiles2, pairs, counts, chord2_table, edges_radian,
                device=mesh.devices[local[0]] if local else device,
            )
        return counts

    if backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"backend 'cuda' needs a CUDA device, got device '{device}'"
        )
    table = np.ascontiguousarray(chord2_table, np.float32)
    misses = _device_table.cache_info().misses
    table = _device_table(table.tobytes(), table.shape, device)
    if _device_table.cache_info().misses == misses:
        count("cache.hit.table")
    lanes1 = tiles1.device_data(device)
    lanes2 = tiles2.device_data(device)
    if backend == "torch":
        result = count_pairs_torch(
            lanes1, lanes2, pairs, table, cols_binned=cols_binned,
            direct=direct, chunk_size=chunk_size,
        )
    else:
        from yet_another_wizz_tpu_torch.ops.cuda_paircount import (
            count_pairs_cuda,
        )

        result = count_pairs_cuda(
            lanes1, lanes2, pairs, table, cols_binned=cols_binned,
            direct=direct,
        )

    if defer and not audit:
        return result
    counts = result.cpu().numpy().astype(np.float64)
    if audit:
        counts, _ = audit_boundary_counts(
            tiles1, tiles2, pairs, counts, chord2_table, edges_radian,
            device=device,
        )
    return counts
