"""The port's direct separation-weighted counting against the JAX package.

Direct counting gives every pair the normalised log-mid weight of its
sub-interval (found in O(1) from the uniform log grid) and counts only at
the scale-limit edges; in float64 it equals the union-edge cumulative
histogram. Held here: the edge tables are EQUAL to the JAX package's, the
per-pair weight agrees with the JAX function, per-scale counts agree with
the JAX engines (xla and the Pallas kernel in interpreter mode) to 1e-5,
with the union-edge cumulative result and the float64 oracle to 2e-5
(small-angle index) and 5e-4 (arcsine index on a wide grid) — the JAX
package's own tolerances (``tests/test_engine.py::TestDirectCounting``): a
1-ulp difference in ``log`` moves a pair within ~1e-7 of a sub-edge into
the neighbouring sub-interval — and a full ``rweight`` measurement agrees
end to end to 5e-5 (counts) and 1e-4 (samples).
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from test_engine import patch_geometry, random_cap_catalog, simple_patches
from yet_another_wizz_tpu.cosmology import new_scales as jax_new_scales
from yet_another_wizz_tpu.ops import gweight as jax_gweight
from yet_another_wizz_tpu.ops.linkage import (
    build_linkage,
    build_tile_pairs,
)
from yet_another_wizz_tpu.ops.paircount import (
    count_pairs_tiles as jax_count_pairs_tiles,
)
from yet_another_wizz_tpu.ops.thresholds import (
    build_angular_edges as jax_build_angular_edges,
)
from yet_another_wizz_tpu.ops.tiles import build_tile_set as jax_build_tile_set
from yet_another_wizz_tpu_torch import interop
from yet_another_wizz_tpu_torch.cosmology import new_scales
from yet_another_wizz_tpu_torch.ops import gweight
from yet_another_wizz_tpu_torch.ops.paircount import count_pairs_tiles
from yet_another_wizz_tpu_torch.ops.thresholds import build_angular_edges

ZMIDS = np.array([0.3, 0.5, 0.8])
NARROW = (([0.05, 0.12, 0.3], [0.2, 0.5, 1.0]), "deg")
"""Overlapping multi-scale limits: the interior limits split uniform
sub-intervals, exercising the below/above adjustments."""
WIDE = (([0.05, 0.4], [0.5, 1.35]), "rad")
"""A grid wider than THETA_POLY_MAX: the arcsine index path."""
TILESET_FIELDS = (
    "lane_data", "tile_patch", "tile_center", "tile_radius",
    "patch_tile_start", "patch_tile_stop", "sum_weights", "tile_zmin",
    "tile_zmax", "num_bins", "num_points",
)


@pytest.fixture(autouse=True)
def float_lanes(monkeypatch):
    """The JAX engines upload float lanes, like the port."""
    monkeypatch.setenv("YAWT_LANE_ENCODING", "float")


def edges_pair(scales, *, weight_scale=-1.0, weight_res=24, counting="direct"):
    """The JAX package's edges and the port's copy of them, built from the
    same arrays (``interop.angular_edges_from_arrays``)."""
    (rmin, rmax), unit = scales
    jax_edges = jax_build_angular_edges(
        jax_new_scales(rmin, rmax, unit=unit), ZMIDS,
        weight_scale=weight_scale, weight_res=weight_res, counting=counting,
    )
    direct = None
    if jax_edges.direct is not None:
        direct = {
            name: getattr(jax_edges.direct, name)
            for name in (
                "chord2_table", "edges", "scale_maps", "gtable", "num_sub",
                "num_below", "num_above",
            )
        }
    edges = interop.angular_edges_from_arrays(
        chord2_table=jax_edges.chord2_table, edges=jax_edges.edges,
        scale_maps=jax_edges.scale_maps, max_angle=jax_edges.max_angle,
        direct=direct,
    )
    return jax_edges, edges


def problem(rng, edges, *, binned_cols=False, num_bins=3, num_patches=4):
    """Tile sets and pair list of the JAX package, and the port's copies."""
    xyz1, w1, z1 = random_cap_catalog(rng, 2500, num_bins)
    xyz2, w2, z2 = random_cap_catalog(rng, 3500, num_bins)
    patch1 = simple_patches(xyz1, num_patches, np.random.default_rng(3))
    patch2 = simple_patches(xyz2, num_patches, np.random.default_rng(3))
    ts1 = jax_build_tile_set(
        xyz1, patch1, num_patches, weights=w1, zbins=z1, num_bins=num_bins,
        tile_size=64,
    )
    extra = dict(zbins=z2, num_bins=num_bins) if binned_cols else {}
    ts2 = jax_build_tile_set(
        xyz2, patch2, num_patches, weights=w2, tile_size=64, **extra
    )
    centers, radii = patch_geometry(xyz1, patch1, num_patches)
    linkage = build_linkage(centers, radii, edges.max_angle * 1.000001)
    pairs = build_tile_pairs(ts1, ts2, linkage, auto=False)
    port = (
        *(
            interop.tileset_from_arrays(
                **{name: getattr(ts, name) for name in TILESET_FIELDS}
            )
            for ts in (ts1, ts2)
        ),
        interop.tilepairs_from_arrays(
            pairs.tile1, pairs.tile2, pairs.slot, pairs.slot_patches
        ),
    )
    return (ts1, ts2, pairs), port


def per_scale(count, inputs, edges, backend, **kwargs):
    """Per-scale counts ``(S, slots, B)`` through ``count`` (either
    package's ``count_pairs_tiles``)."""
    if edges.direct is not None and backend != "oracle":
        cumulative = count(
            *inputs, edges.direct.combined_table(), backend=backend,
            direct=edges.direct.spec, **kwargs,
        )
        return edges.direct.counts_to_scales(cumulative)
    cumulative = count(
        *inputs, edges.chord2_table, backend=backend,
        edges_radian=edges.edges, **kwargs,
    )
    return edges.counts_to_scales(cumulative)


def port_per_scale(inputs, edges, backend="auto"):
    return per_scale(count_pairs_tiles, inputs, edges, backend, device="cpu")


def jax_per_scale(inputs, edges, backend):
    return per_scale(jax_count_pairs_tiles, inputs, edges, backend, mesh="single")


@pytest.mark.parametrize(
    "scales, weight_scale, weight_res, counting",
    [
        (NARROW, -1.0, 24, "direct"),
        (NARROW, 1.5, 24, "direct"),
        (NARROW, -1.0, 24, "auto"),
        (NARROW, -1.0, 4, "auto"),
        (NARROW, -1.0, 4, "direct"),
        (NARROW, None, 24, "auto"),
        (WIDE, -1.0, 24, "direct"),
    ],
)
def test_edge_tables_equal_jax(scales, weight_scale, weight_res, counting):
    (rmin, rmax), unit = scales
    kwargs = dict(
        weight_scale=weight_scale, weight_res=weight_res, counting=counting
    )
    expected = jax_build_angular_edges(
        jax_new_scales(rmin, rmax, unit=unit), ZMIDS, **kwargs
    )
    edges = build_angular_edges(new_scales(rmin, rmax, unit=unit), ZMIDS, **kwargs)
    for name in ("chord2_table", "edges", "scale_maps"):
        assert getattr(edges, name).tobytes() == getattr(expected, name).tobytes()
    assert edges.max_angle == expected.max_angle
    assert edges.num_counting_edges == expected.num_counting_edges
    assert (edges.direct is None) == (expected.direct is None)
    if expected.direct is None:
        return
    for name in ("chord2_table", "edges", "scale_maps", "gtable"):
        actual, desired = getattr(edges.direct, name), getattr(expected.direct, name)
        assert actual.dtype == desired.dtype
        assert_array_equal(actual, desired)
    assert edges.direct.spec == expected.direct.spec
    assert edges.direct.combined_table().tobytes() == (
        expected.direct.combined_table().tobytes()
    )


def test_counting_modes_are_chosen_as_in_jax():
    scales = new_scales(*NARROW[0], unit="deg")
    assert build_angular_edges(scales, ZMIDS, weight_scale=-1.0, weight_res=24).direct is not None
    assert build_angular_edges(scales, ZMIDS, weight_scale=-1.0, weight_res=4).direct is None
    assert build_angular_edges(scales, ZMIDS).direct is None
    wide = build_angular_edges(
        new_scales(*WIDE[0], unit="rad"), ZMIDS, weight_scale=-1.0,
        weight_res=24, counting="direct",
    )
    assert wide.direct.spec[3] is False
    with pytest.raises(ValueError, match="direct"):
        build_angular_edges(scales, ZMIDS, counting="direct")


@pytest.mark.parametrize("small_angle", [True, False])
def test_direct_weight_matches_jax(small_angle):
    """Pair weights of the plain version against the JAX function, on
    chords spread over the grid and signed column weights. A pair within
    float32 resolution of a sub-edge may take the neighbouring weight."""
    jax_edges, _ = edges_pair(WIDE if not small_angle else NARROW)
    direct = jax_edges.direct
    rng = np.random.default_rng(4)
    lo, hi = direct.edges.min() * 0.5, direct.edges.max() * 1.2
    theta = np.exp(rng.uniform(np.log(lo), np.log(hi), (256, 256)))
    chord2 = ((2 * np.sin(theta / 2)) ** 2).astype(np.float32)
    weights = rng.normal(0.0, 1.0, (256, 256)).astype(np.float32)
    rows = rng.integers(0, len(ZMIDS), 256)
    params = direct.gtable[rows]  # (256, C)
    spec = dict(
        num_sub=direct.num_sub, num_below=direct.num_below,
        num_above=direct.num_above, small_angle=small_angle,
    )
    expected = np.asarray(
        jax_gweight.apply_direct_weight(chord2, params, weights, **spec)
    )
    actual = gweight.apply_direct_weight(
        torch.from_numpy(chord2), torch.from_numpy(params),
        torch.from_numpy(weights), **spec,
    ).numpy()
    close = np.isclose(actual, expected, rtol=1e-6, atol=0.0)
    assert close.mean() > 0.999
    # the rest took a neighbouring sub-interval's weight
    ratio = np.abs(actual[~close] / expected[~close])
    step = np.exp(abs(direct.gtable[:, 3]).max()) * 1.01
    assert np.all((ratio < step) & (ratio > 1 / step))
    assert gweight.counting_width(20, (32, 2, 2)) == 4
    assert gweight.num_param_cols(2, 2) == 16


@pytest.mark.parametrize("scales", [NARROW, WIDE], ids=["small_angle", "arcsine"])
@pytest.mark.parametrize("binned_cols", [False, True], ids=["cross", "binned"])
def test_direct_counts_match_jax_xla(rng, scales, binned_cols):
    jax_edges, edges = edges_pair(scales)
    jax_inputs, inputs = problem(rng, jax_edges, binned_cols=binned_cols)
    expected = jax_per_scale(jax_inputs, jax_edges, "xla")
    assert_allclose(
        port_per_scale(inputs, edges), expected, rtol=1e-5,
        atol=1e-5 * np.abs(expected).max(),
    )


@pytest.mark.parametrize("scales", [NARROW, WIDE], ids=["small_angle", "arcsine"])
def test_direct_counts_match_pallas_interpret(rng, scales):
    jax_edges, edges = edges_pair(scales)
    jax_inputs, inputs = problem(rng, jax_edges)
    expected = jax_per_scale(jax_inputs, jax_edges, "pallas")
    assert_allclose(
        port_per_scale(inputs, edges), expected, rtol=1e-5,
        atol=1e-5 * np.abs(expected).max(),
    )


@pytest.mark.parametrize(
    "scales, alpha, rtol",
    [(NARROW, -1.0, 2e-5), (NARROW, 1.5, 2e-5), (WIDE, -1.0, 5e-4)],
    ids=["small_angle", "small_angle_positive_alpha", "arcsine"],
)
def test_direct_matches_cumulative_and_oracle(rng, scales, alpha, rtol):
    """Direct counting reproduces the union-edge cumulative histogram and
    the float64 oracle (the oracle on the small-angle grid only: the wide
    grid pairs almost every point)."""
    jax_direct, direct = edges_pair(scales, weight_scale=alpha)
    _, cumulative = edges_pair(scales, weight_scale=alpha, counting="cumulative")
    assert direct.direct is not None and cumulative.direct is None
    _, inputs = problem(rng, jax_direct)
    via_direct = port_per_scale(inputs, direct)
    via_cumulative = port_per_scale(inputs, cumulative)
    assert_allclose(via_direct, via_cumulative, rtol=rtol, atol=1e-7)
    if scales is NARROW:
        via_oracle = port_per_scale(inputs, cumulative, "oracle")
        assert_allclose(via_direct, via_oracle, rtol=rtol, atol=1e-7)


def test_direct_refuses_oracle_and_audit(rng):
    jax_edges, edges = edges_pair(NARROW)
    _, inputs = problem(rng, jax_edges)
    table = edges.direct.combined_table()
    with pytest.raises(ValueError, match="direct"):
        count_pairs_tiles(
            *inputs, table, backend="oracle", direct=edges.direct.spec,
            edges_radian=edges.direct.edges,
        )
    with pytest.raises(ValueError, match="direct"):
        count_pairs_tiles(
            *inputs, table, device="cpu", direct=edges.direct.spec,
            audit=True, edges_radian=edges.direct.edges,
        )


@pytest.fixture(scope="module")
def rweight_measurement():
    """A full crosscorrelation with rweight at resolution 32 in both
    packages, and the port's oracle backend (union-edge float64 path)."""
    from yet_another_wizz_tpu import Catalog as JaxCatalog
    from yet_another_wizz_tpu import Configuration as JaxConfiguration
    from yet_another_wizz_tpu.correlation.measurements import (
        crosscorrelate as jax_crosscorrelate,
    )
    from yet_another_wizz_tpu.examples import generate_mock_data
    from yet_another_wizz_tpu_torch import Catalog, Configuration, crosscorrelate
    from yet_another_wizz_tpu_torch.correlation.measurements import PatchLinkage

    config = dict(
        rmin=[300, 500, 1000], rmax=[1000, 3000, 5000], unit="kpc",
        zmin=0.15, zmax=1.0, num_bins=3, rweight=-1.0, resolution=32,
    )
    mock = generate_mock_data(1200, 1800, 3000, seed=5)
    results = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YAWT_LANE_ENCODING", "float")
        for name, catalog_cls in (("jax", JaxCatalog), ("port", Catalog)):
            ref = catalog_cls.from_arrays(
                **mock["reference"], degrees=False, patch_num=4
            )
            centers = ref.get_centers()
            results[name] = [
                ref,
                *(
                    catalog_cls.from_arrays(
                        **mock[sample], degrees=False, patch_centers=centers
                    )
                    for sample in ("unknown", "randoms")
                ),
            ]
        jax_cats, cats = results["jax"], results["port"]
        port_config = Configuration.create(**config)
        links = PatchLinkage.from_catalogs(port_config, *cats)
        assert links.edges.direct is not None  # the auto heuristic engaged
        return dict(
            jax=jax_crosscorrelate(
                JaxConfiguration.create(**config), *jax_cats[:2],
                ref_rand=jax_cats[2], backend="xla", mesh="single",
            ),
            port=crosscorrelate(
                port_config, *cats[:2], ref_rand=cats[2], device="cpu"
            ),
            oracle=crosscorrelate(
                port_config, *cats[:2], ref_rand=cats[2], backend="oracle",
                device="cpu",
            ),
        )


@pytest.mark.parametrize("against", ["oracle", "jax"])
def test_rweight_measurement_agrees(rweight_measurement, against):
    for corr, expected in zip(
        rweight_measurement["port"], rweight_measurement[against]
    ):
        for count in ("dd", "rd"):
            assert_allclose(
                getattr(corr, count).counts.counts,
                getattr(expected, count).counts.counts, rtol=5e-5, atol=1e-7,
            )
        assert_allclose(corr.sample().data, expected.sample().data, rtol=1e-4)
