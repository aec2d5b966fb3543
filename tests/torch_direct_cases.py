"""Inputs of the direct kernels' chunk-skip tests: weighted points in a
spherical cap, tiled by patch, paired by a patch linkage, and the combined
table of a separation-weighted grid counted directly, with the small-angle
(K1.3) or the arcsine index (K1.4).

Shared by ``test_torch_direct_skip.py`` (the skip rule's plain mirror on
the CPU) and ``test_torch_cuda.py`` (the kernels on the card). No JAX
import: the card's machine has no JAX.
"""

import numpy as np

from yet_another_wizz_tpu_torch.cosmology import new_scales
from yet_another_wizz_tpu_torch.ops.linkage import build_linkage, build_tile_pairs
from yet_another_wizz_tpu_torch.ops.thresholds import build_angular_edges
from yet_another_wizz_tpu_torch.ops.tiles import build_tile_set

GRIDS = {
    # name: (rmin, rmax), unit, half-angle of the points' cap in degrees
    "small_angle": (([0.05, 0.12, 0.3], [0.2, 0.5, 1.0]), "deg", 4.0),
    # edges beyond 1.2 rad take the arcsine index; points over most of the
    # sphere, so that some chunks lie beyond the widest edge
    "arcsine": (([0.05, 0.4], [0.5, 1.35]), "rad", 150.0),
    # ten overlapping scales: 20 counting edges, two launches per count
    "many": (
        (
            [0.05, 0.061, 0.0745, 0.0909, 0.1109, 0.1353, 0.1651, 0.2015,
             0.2458, 0.3],
            [0.6, 0.6859, 0.7841, 0.8963, 1.0246, 1.1712, 1.3389, 1.5305,
             1.7496, 2.0],
        ),
        "deg",
        4.0,
    ),
}
NUM_BINS = 3


def cap_points(rng, n: int, cap_deg: float):
    """Unit vectors uniform in a spherical cap around the z axis."""
    mu = rng.uniform(np.cos(np.deg2rad(cap_deg)), 1.0, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    s = np.sqrt(1 - mu**2)
    return np.column_stack([s * np.cos(phi), s * np.sin(phi), mu])


def direct_inputs(grid: str, cols_binned: bool, *, sizes=(400, 600),
                  tile_size: int = 64, num_patches: int = 3, seed: int = 7):
    """``(tiles1, tiles2, pairs, table, direct)`` of one direct count:
    rows binned into :data:`NUM_BINS` bins, columns binned with
    ``cols_binned``, weights in [0.5, 2], every tile pair of the patch pairs
    the linkage links at the grid's widest edge, the grid's combined table
    and its direct specification."""
    (rmin, rmax), unit, cap_deg = GRIDS[grid]
    rng = np.random.default_rng(seed)
    xyz1, xyz2 = (cap_points(rng, n, cap_deg) for n in sizes)
    w1, w2 = (rng.uniform(0.5, 2.0, n) for n in sizes)
    z1, z2 = (rng.integers(0, NUM_BINS, n) for n in sizes)
    centers = xyz1[rng.choice(len(xyz1), num_patches, replace=False)]
    patch1 = np.argmax(xyz1 @ centers.T, axis=1)
    patch2 = np.argmax(xyz2 @ centers.T, axis=1)
    tiles1 = build_tile_set(
        xyz1, patch1, num_patches, weights=w1, zbins=z1, num_bins=NUM_BINS,
        tile_size=tile_size,
    )
    extra = dict(zbins=z2, num_bins=NUM_BINS) if cols_binned else {}
    tiles2 = build_tile_set(
        xyz2, patch2, num_patches, weights=w2, tile_size=tile_size, **extra
    )
    edges = build_angular_edges(
        new_scales(rmin, rmax, unit=unit), np.linspace(0.3, 0.8, NUM_BINS),
        weight_scale=-1.0, weight_res=24, counting="direct",
    )
    radii = np.zeros(num_patches)
    for xyz, patch in ((xyz1, patch1), (xyz2, patch2)):
        angle = np.arccos(np.clip(np.sum(xyz * centers[patch], axis=1), -1, 1))
        np.maximum.at(radii, patch, angle)
    linkage = build_linkage(centers, radii * 1.000001, edges.max_angle * 1.000001)
    pairs = build_tile_pairs(tiles1, tiles2, linkage, auto=False)
    return (
        tiles1, tiles2, pairs, edges.direct.combined_table(), edges.direct.spec
    )
