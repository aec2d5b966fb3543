"""The least time the pair counts of a measurement could take on one H100.

The work is what the inputs need, counted by the reference from the inputs
(pairs in reach), never from the program's tiles or launch groups. The
arithmetic is that of ``reach_operations`` in ``chip_smoke.py``:

- 16 float32 operations for each pair within its row's largest edge (the
  compensated chord and the compare against the row's reach), +1 when both
  sides are binned (the bin compare);
- 3 per counting edge for each such pair (compare, select, add);
- with separation weights, the cheaper of the two formulations: every union
  edge counted cumulatively, or only the scale edges with the pair's weight
  computed directly (12 operations with the small-angle index, 18 with the
  arcsine index beyond 1.2 rad, and 1 for its product with the weights).

It assumes that every pair in reach is evaluated; an algorithm that accepts
or rejects pairs of tree nodes whole needs less, and would need this count
redone. Bytes: each input point once (x, y, z, weight and bin as five
float32) and each output count once (float32 per bin, patch pair and counting
edge). Peaks: NVIDIA's data sheet for the H100 SXM at 700 W.
"""

from __future__ import annotations

F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
CHORD_OPS = 16
BIN_COMPARE_OPS = 1
EDGE_OPS = 3
WEIGHT_OPS_SMALL_ANGLE = 12
WEIGHT_OPS_ARCSINE = 18
WEIGHT_PRODUCT_OPS = 1
SMALL_ANGLE_LIMIT = 1.2
POINT_BYTES = 20
COUNT_BYTES = 4


def edge_ops(work: dict) -> tuple[int, int]:
    """Operations per pair in reach for the edges, and the counting edges
    of the formulation that takes them."""
    cumulative = EDGE_OPS * work["union_edges"]
    if not work["weighted"]:
        return cumulative, work["union_edges"]
    weight = (WEIGHT_OPS_SMALL_ANGLE if work["max_angle"] <= SMALL_ANGLE_LIMIT
              else WEIGHT_OPS_ARCSINE)
    direct = EDGE_OPS * work["scale_edges"] + weight + WEIGHT_PRODUCT_OPS
    if direct < cumulative:
        return direct, work["scale_edges"]
    return cumulative, work["union_edges"]


def count_operations(work: dict) -> float:
    ops, _ = edge_ops(work)
    per_pair = CHORD_OPS + (BIN_COMPARE_OPS if work["binned"] else 0) + ops
    return float(work["pairs_in_reach"]) * per_pair


def count_bytes(work: dict) -> float:
    _, edges = edge_ops(work)
    outputs = work["num_bins"] * work["num_patches"] ** 2 * edges
    return float(work["num_points"]) * POINT_BYTES + outputs * COUNT_BYTES


def least_seconds(works: list) -> float:
    """The least time of one measurement's counts, each bound by operations
    or bytes, whichever is slower."""
    return sum(max(count_operations(w) / F32_OPS_PER_S,
                   count_bytes(w) / HBM_BYTES_PER_S) for w in works)
