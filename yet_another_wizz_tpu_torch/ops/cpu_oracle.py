"""Float64 CPU reference implementation of the pair-count engine.

Uses scipy kd-trees exactly like the reference package
(yaw/catalog/trees.py:303-362: per-patch trees,
``count_neighbors`` with chord-distance radii and pair weights). Serves two
purposes:

- numerical oracle: the device engine must reproduce these counts to the
  1e-6 relative target on mock catalogs;
- performance baseline: a multiprocess run of this implementation stands in
  for the reference package — it uses the identical scipy C++ kernel the
  reference delegates to.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import TYPE_CHECKING

import numpy as np
from scipy.spatial import KDTree

from yet_another_wizz_tpu_torch.coordinates import angle_to_chord

if TYPE_CHECKING:
    from numpy.typing import NDArray

__all__ = [
    "count_pairs_oracle",
    "count_pairs_oracle_multiprocess",
]


def _tree_counts(
    xyz1, w1, tree2, w2, radii: NDArray
) -> NDArray:
    """Cumulative weighted pair counts at the given chord radii."""
    if len(xyz1) == 0 or tree2 is None:
        return np.zeros(len(radii))
    tree1 = KDTree(xyz1, leafsize=16)
    return tree1.count_neighbors(
        tree2, r=radii, weights=(w1, w2), cumulative=True
    ).astype(np.float64)


def _slot_counts(args):
    (xyz1, w1, z1, xyz2, w2, z2, edges, cols_binned) = args
    num_bins, num_edges = edges.shape
    out = np.zeros((num_bins, num_edges))
    # unbinned columns: ONE shared tree over the whole column patch (a
    # per-bin rebuild is pure waste — only the row side depends on b)
    shared_tree2 = None
    if not cols_binned and len(xyz2):
        shared_tree2 = KDTree(xyz2, leafsize=16)
    for b in range(num_bins):
        sel1 = z1 == b
        if not np.any(sel1):
            continue
        if cols_binned:
            sel2 = z2 == b
            if not np.any(sel2):
                continue
            tree2 = KDTree(xyz2[sel2], leafsize=16)
            w2_sel = w2[sel2]
        else:
            tree2 = shared_tree2
            w2_sel = w2
        radii = angle_to_chord(edges[b])
        out[b] = _tree_counts(xyz1[sel1], w1[sel1], tree2, w2_sel, radii)
    return out


def _build_tasks(
    xyz1, w1, zbin1, patch1, xyz2, w2, zbin2, patch2, slot_patches, edges
):
    cols_binned = zbin2 is not None
    if zbin2 is None:
        zbin2 = np.zeros(len(xyz2), dtype=int)
    for p1, p2 in slot_patches:
        in1 = patch1 == p1
        in2 = patch2 == p2
        yield (
            xyz1[in1], w1[in1], zbin1[in1],
            xyz2[in2], w2[in2], zbin2[in2],
            edges, cols_binned,
        )


def count_pairs_oracle(
    xyz1: NDArray,
    w1: NDArray,
    zbin1: NDArray,
    patch1: NDArray,
    xyz2: NDArray,
    w2: NDArray,
    zbin2: NDArray | None,
    patch2: NDArray,
    slot_patches: NDArray,
    edges: NDArray,
    *,
    max_workers: int = 1,
) -> NDArray:
    """Cumulative weighted pair counts per (patch-pair slot, bin, edge).

    Args:
        xyz1, w1, zbin1, patch1: float64 positions, weights, bin indices and
            patch ids of the binned (row) catalog.
        xyz2, w2, zbin2, patch2: same for the column catalog; ``zbin2=None``
            marks it unbinned.
        slot_patches: ``(num_slots, 2)`` patch-id pairs to process.
        edges: ``(B, E)`` angular edges in radian (non-decreasing per bin).

    Returns:
        float64 array ``(num_slots, B, E)``: entry (n, b, e) is the sum of
        ``w_i * w_j`` over pairs with chord distance <= chord(edges[b, e]).

    With ``max_workers > 1`` the slots are counted on that many threads
    (the kd-trees release the interpreter lock); each slot is counted
    whole by one thread, so the result is the same bits. Threads start
    at no cost, where a process pool's workers each import the package.
    """
    tasks = _build_tasks(
        xyz1, w1, zbin1, patch1, xyz2, w2, zbin2, patch2, slot_patches, edges
    )
    if max_workers > 1:
        with ThreadPoolExecutor(max_workers) as pool:
            return np.stack(list(pool.map(_slot_counts, tasks)))
    return np.stack([_slot_counts(task) for task in tasks])


def count_pairs_oracle_multiprocess(
    xyz1, w1, zbin1, patch1, xyz2, w2, zbin2, patch2, slot_patches, edges,
    *,
    max_workers: int | None = None,
) -> NDArray:
    """Multiprocess variant of :func:`count_pairs_oracle` (the CPU
    performance baseline, analogous to the reference's process pool over
    patch pairs, yaw/utils/parallel.py:318-343).

    Worker count defaults to the ``YAWT_NUM_THREADS`` environment
    variable (or the reference's ``YAW_NUM_THREADS`` as an alias,
    yaw/utils/parallel.py:75-85) or the CPU count."""
    if max_workers is None:
        from yet_another_wizz_tpu_torch.utils.misc import host_thread_count

        max_workers = host_thread_count()
    tasks = list(
        _build_tasks(
            xyz1, w1, zbin1, patch1, xyz2, w2, zbin2, patch2, slot_patches,
            edges,
        )
    )
    # spawn context: forking after torch initialises its thread pools is
    # prone to deadlocks
    context = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(
        max_workers=max_workers, mp_context=context
    ) as pool:
        results = list(pool.map(_slot_counts, tasks, chunksize=4))
    return np.stack(results)
