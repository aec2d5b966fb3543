"""The reference's pair counts equal a brute-force double loop over every
pair, on a tiny catalog, cumulative and separation-weighted, cross and auto."""

import numpy as np
import pytest

from harness import inputs
from harness import reference as ref

EDGES_Z = np.linspace(0.15, 1.0, 5)
SCALES = {
    "single": {"rmin": 100, "rmax": 1000, "unit": "kpc"},
    "weighted": {"rmin": [100, 300], "rmax": [300, 1000], "unit": "kpc",
                 "rweight": -1.0, "resolution": 8},
}


def tiny_samples(seed=3):
    rng = np.random.default_rng(seed)

    def sample(n):
        ra = rng.uniform(np.deg2rad(40.0), np.deg2rad(40.6), n)
        dec = rng.uniform(np.deg2rad(-0.3), np.deg2rad(0.3), n)
        return dict(ra=ra, dec=dec, redshifts=rng.uniform(0.1, 1.0, n),
                    weights=rng.uniform(0.5, 2.0, n))

    first, second = sample(300), sample(400)
    centers = inputs.radec_to_xyz(np.deg2rad([40.15, 40.45, 40.3]),
                                  np.deg2rad([-0.1, 0.1, 0.2]))
    return (ref.make_sample(first, centers, EDGES_Z),
            ref.make_sample(second, centers, EDGES_Z), len(centers))


def brute_force(rows, cols, edges, num_patches, binned2, auto):
    """Every ordered pair, one at a time, in float64."""
    num_bins, num_edges = edges.angles.shape
    out = np.zeros((num_bins, num_patches, num_patches, num_edges - 1))
    for i in range(len(rows.bins)):
        b = rows.bins[i]
        if b < 0:
            continue
        for j in range(len(cols.bins)):
            if binned2 and cols.bins[j] != b:
                continue
            d = np.sum((rows.xyz[i] - cols.xyz[j]) ** 2)
            thresholds = ref.chord2(edges.angles[b])
            for k in range(num_edges - 1):
                if thresholds[k] < d <= thresholds[k + 1]:
                    out[b, rows.patches[i], cols.patches[j], k] += (
                        rows.weights[i] * cols.weights[j])
    return out


@pytest.mark.parametrize("scales", sorted(SCALES))
@pytest.mark.parametrize("kind", ["cross", "auto"])
def test_counts_equal_a_double_loop(scales, kind):
    rows, cols, num_patches = tiny_samples()
    if kind == "auto":
        cols = rows
    mids = 0.5 * (EDGES_Z[1:] + EDGES_Z[:-1])
    edges = ref.build_edges(SCALES[scales], mids)
    counted = ref.count_pairs(rows, cols, edges, num_patches, binned2=kind == "auto",
                              auto=kind == "auto", device="cpu")
    expected = brute_force(rows, cols, edges, num_patches, kind == "auto", kind == "auto")
    assert counted.intervals.sum() > 0
    np.testing.assert_allclose(counted.intervals, expected, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("scales", sorted(SCALES))
def test_near_weights_equal_a_double_loop(scales):
    """The weight of the pairs within a relative band of each edge."""
    rows, cols, num_patches = tiny_samples(4)
    mids = 0.5 * (EDGES_Z[1:] + EDGES_Z[:-1])
    edges = ref.build_edges(SCALES[scales], mids)
    band = 0.05
    counted = ref.count_pairs(rows, cols, edges, num_patches, binned2=False,
                              auto=False, device="cpu", bands=(band,))
    expected = np.zeros(counted.near.shape[1:])
    for i in np.flatnonzero(rows.bins >= 0):
        b = rows.bins[i]
        thresholds = ref.chord2(edges.angles[b])
        d = np.sum((rows.xyz[i] - cols.xyz) ** 2, axis=1)
        for e in np.unique(thresholds, return_index=True)[1]:
            close = np.abs(d - thresholds[e]) <= band * thresholds[e]
            np.add.at(expected, (b, rows.patches[i], cols.patches[close], e),
                      rows.weights[i] * cols.weights[close])
    assert expected.sum() > 0
    np.testing.assert_allclose(counted.near[0], expected, rtol=1e-12, atol=1e-12)


def test_strips_hold_every_pair_in_reach():
    """With the reach widened to the whole patch, the blocks still cover
    every pair, each once."""
    rows, cols, _ = tiny_samples(5)
    seen = np.zeros((len(rows.bins), len(cols.bins)), dtype=int)
    for idx_r, idx_c in ref.candidate_blocks(rows, cols, 0.004):
        seen[np.ix_(idx_r, idx_c)] += 1
    assert seen.max() == 1
    d = ((rows.xyz[:, None, :] - cols.xyz[None, :, :]) ** 2).sum(-1)
    assert np.all(seen[d <= ref.chord2(0.004)] == 1)
