"""Compute layer: tiled brute-force pair counting and clustering.

- :mod:`tiles`          — spatially sorted, padded point tiles (the device
                          layout replacing per-patch kd-trees)
- :mod:`linkage`        — patch- and tile-level pair pruning by bounding caps
- :mod:`thresholds`     — per-redshift-bin angular edges and chord-distance
                          threshold tables
- :mod:`paircount`      — the pair-count engine dispatch and its plain
                          PyTorch version, producing (patch-pair, bin, edge)
                          cumulative count tensors
- :mod:`cuda_paircount` — the hand-written CUDA pair-count kernels
- :mod:`kmeans`         — spherical kmeans for patch centers
- :mod:`cpu_oracle`     — float64 scipy kd-tree implementation used for
                          validation
"""

from yet_another_wizz_tpu_torch.ops.tiles import TileSet, build_tile_set
from yet_another_wizz_tpu_torch.ops.linkage import Linkage, TilePairs, build_linkage
from yet_another_wizz_tpu_torch.ops.thresholds import AngularEdges, build_angular_edges
from yet_another_wizz_tpu_torch.ops.paircount import count_pairs_tiles

__all__ = [
    "AngularEdges",
    "Linkage",
    "TilePairs",
    "TileSet",
    "build_angular_edges",
    "build_linkage",
    "build_tile_set",
    "count_pairs_tiles",
]
