"""The engineered on-edge pair of the exact-boundary audit.

Shared by ``test_torch_audit.py`` (the port against the JAX package on the
CPU), ``test_torch_cuda.py`` (the audit on the card) and ``chip_smoke.py``.
No JAX import: the card's machine has no JAX.

:func:`on_edge_case` builds the inputs of the JAX package's
``tests/test_engine.py::TestBoundaryAudit._measure`` from the same random
draws: two random catalogs in a 20 degree cap, with one heavy pair (weight
100 on each side) at ``nudge`` times the upper edge of 1 degree. Near
``nudge = 1`` the pair lies within float32 resolution of the edge, and at
``nudge = 1 + 1e-8`` it lies between the float32 and the float64 threshold,
so the engine counts its whole weight (1e4) on the wrong side of the edge.
"""

import numpy as np

from yet_another_wizz_tpu_torch.coordinates import radec_to_xyz
from yet_another_wizz_tpu_torch.ops.linkage import build_linkage, build_tile_pairs
from yet_another_wizz_tpu_torch.ops.tiles import build_tile_set

NUM_BINS = 2
NUM_PATCHES = 4
TILE_SIZE = 64
EDGES_DEG = np.array([0.2, 1.0])


def random_cap_catalog(rng, n, num_bins, cap_deg=20.0):
    """Random points in a spherical cap around (ra, dec) = (1, 0.3) rad,
    weights in [0.5, 2) and random bins (``tests/test_engine.py``)."""
    cos_max = np.cos(np.deg2rad(cap_deg))
    mu = rng.uniform(cos_max, 1.0, n)
    theta = np.arccos(mu)
    phi = rng.uniform(0, 2 * np.pi, n)
    xyz_local = np.column_stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), mu]
    )
    center = radec_to_xyz([1.0], [0.3])[0]
    z_axis = np.array([0.0, 0.0, 1.0])
    v = np.cross(z_axis, center)
    s, c = np.linalg.norm(v), np.dot(z_axis, center)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    rot = np.eye(3) + vx + vx @ vx * ((1 - c) / s**2)
    xyz = xyz_local @ rot.T
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    weights = rng.uniform(0.5, 2.0, n)
    zbins = rng.integers(0, num_bins, n)
    return xyz, weights, zbins


def patch_geometry(xyz, patch_ids, num_patches):
    """Patch centers (mean direction) and radii (radian) of a point set."""
    centers = np.zeros((num_patches, 3))
    radii = np.zeros(num_patches)
    for p in range(num_patches):
        pts = xyz[patch_ids == p]
        if len(pts) == 0:
            centers[p, 0] = 1.0
            continue
        center = pts.mean(axis=0)
        center /= np.linalg.norm(center)
        centers[p] = center
        chord = np.linalg.norm(pts - center, axis=1)
        radii[p] = 2 * np.arcsin(np.min([chord.max() / 2, 1.0]))
    return centers, radii


def on_edge_case(rng, nudge):
    """The arrays of the engineered case: ``xyz1, w1, z1, patch1`` (binned
    rows), ``xyz2, w2, patch2`` (unbinned columns), ``edges`` (radian, per
    bin) and ``chord2`` (the float32 squared-chord table)."""
    xyz1, w1, z1 = random_cap_catalog(rng, 400, NUM_BINS)
    xyz2, w2, _ = random_cap_catalog(rng, 600, NUM_BINS)

    theta = np.deg2rad(EDGES_DEG[1]) * nudge
    a = radec_to_xyz([1.0], [0.3])[0]
    t = np.cross(a, [0.0, 0.0, 1.0])
    t /= np.linalg.norm(t)
    b = np.cos(theta) * a + np.sin(theta) * t
    xyz1 = np.vstack([xyz1, a])
    xyz2 = np.vstack([xyz2, b])
    w1 = np.append(w1, 100.0)
    w2 = np.append(w2, 100.0)
    z1 = np.append(z1, 0)

    centers = xyz1[
        np.random.default_rng(3).choice(len(xyz1), NUM_PATCHES, replace=False)
    ]
    patch1 = np.argmax(xyz1 @ centers.T, axis=1)
    patch2 = np.argmax(xyz2 @ centers.T, axis=1)
    edges = np.deg2rad(np.tile(EDGES_DEG, (NUM_BINS, 1)))
    chord2 = ((2 * np.sin(edges / 2)) ** 2).astype(np.float32)
    return dict(
        xyz1=xyz1, w1=w1, z1=z1, patch1=patch1,
        xyz2=xyz2, w2=w2, patch2=patch2, edges=edges, chord2=chord2,
    )


def port_inputs(case):
    """The port's tile sets and tile-pair list of the case."""
    ts1 = build_tile_set(
        case["xyz1"], case["patch1"], NUM_PATCHES, weights=case["w1"],
        zbins=case["z1"], num_bins=NUM_BINS, tile_size=TILE_SIZE,
    )
    ts2 = build_tile_set(
        case["xyz2"], case["patch2"], NUM_PATCHES, weights=case["w2"],
        tile_size=TILE_SIZE,
    )
    centers, radii = patch_geometry(case["xyz1"], case["patch1"], NUM_PATCHES)
    linkage = build_linkage(centers, radii, case["edges"].max() * 1.000001)
    return ts1, ts2, build_tile_pairs(ts1, ts2, linkage, auto=False)


def oracle_inputs(case, pairs):
    """The arguments of ``count_pairs_oracle`` for the slots of ``pairs``."""
    return (
        case["xyz1"], case["w1"], case["z1"], case["patch1"],
        case["xyz2"], case["w2"], None, case["patch2"],
        pairs.slot_patches, case["edges"],
    )
