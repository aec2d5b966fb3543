"""The survey proof's ingestion and measurement, port against the JAX package.

On the survey proof's own Parquet files and patch centres
(``scripts/torch_survey_proof.py::prepare`` at 24k rows, 8 patches, row
groups of 1,200 rows):

- the port's streaming ingestion in reader rounds of 2,400 rows (2, 4 and
  5 rounds) writes caches byte for byte those of the JAX package's
  ``Catalog.from_file(streaming=True, chunksize=2400)`` and of the port's
  own ingestion in one round;
- the port's blocked ``crosscorrelate(max_resident_patches=3)`` on its
  ``LazyCatalog`` caches agrees with the JAX package's on the JAX
  package's ``LazyCatalog`` caches (XLA engine, float lanes, as its
  blocked tests run it on the CPU): counts and n(z) with its errors within
  1e-6 relative, and the same ``num_block_pairs`` and ``candidate_pairs``;
- the two on-edge pairs that made the 1e8-row proof's oracle gate fail:
  the audit counts them as the float64 oracle does.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import torch_survey_proof as proof  # noqa: E402

from yet_another_wizz_tpu.catalog import Catalog as JaxCatalog  # noqa: E402
from yet_another_wizz_tpu.catalog import LazyCatalog as JaxLazyCatalog  # noqa: E402
from yet_another_wizz_tpu.coordinates import (  # noqa: E402
    AngularCoordinates as JaxAngularCoordinates,
)
from yet_another_wizz_tpu.correlation import blocked as jax_blocked  # noqa: E402
from yet_another_wizz_tpu.correlation.measurements import (  # noqa: E402
    crosscorrelate as jax_crosscorrelate,
)
from yet_another_wizz_tpu.redshifts import RedshiftData as JaxRedshiftData  # noqa: E402
from yet_another_wizz_tpu_torch.catalog import Catalog, LazyCatalog  # noqa: E402
from yet_another_wizz_tpu_torch.coordinates import AngularCoordinates  # noqa: E402
from yet_another_wizz_tpu_torch.correlation.measurements import crosscorrelate  # noqa: E402
from yet_another_wizz_tpu_torch.redshifts import RedshiftData  # noqa: E402
from yet_another_wizz_tpu_torch.utils import tracing  # noqa: E402

TINY = ["--rows", "24000", "--patches", "8", "--resident", "3", "--ingest-chunk", "2400",
        "--parquet-chunk", "1200", "--downsample", "4", "--device", "cpu"]
COLUMNS = dict(ra_name="ra", dec_name="dec", redshift_name="z", weight_name="w")
RTOL = 1e-6


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The port's caches from the proof's prepare stage, the JAX package's
    and the port's single-round caches of the same files and centres."""
    workdir = tmp_path_factory.mktemp("proof_parity")
    args = proof.parse_args(TINY)
    info = proof.prepare(workdir, args)
    centers = np.load(workdir / "centers.npy")
    for name in proof.NAMES:
        path = workdir / f"{name}.pqt"
        JaxCatalog.from_file(
            workdir / f"jax_{name}", path, patch_centers=JaxAngularCoordinates(centers),
            streaming=True, chunksize=args.ingest_chunk, **COLUMNS,
        )
        Catalog.from_file(
            workdir / f"single_{name}", path, patch_centers=AngularCoordinates(centers),
            streaming=True, device="cpu", **COLUMNS,
        )
    return workdir, args, info


def cache_files(root: Path) -> dict:
    return {
        path.relative_to(root).as_posix(): path.read_bytes()
        for path in sorted(root.rglob("*")) if path.is_file() and "tiles" not in path.parts
    }


@pytest.mark.parametrize("other", ["jax", "single"])
@pytest.mark.parametrize("name", proof.NAMES)
def test_streamed_caches_are_byte_identical(prepared, name, other):
    workdir, args, info = prepared
    assert info["ingestion_rounds"][name]["rounds"] >= 2
    ours = cache_files(workdir / f"cache_{name}")
    theirs = cache_files(workdir / f"{other}_{name}")
    assert len(ours) == 2 * args.patches + 1  # data.bin, meta.yml per patch; patch ids
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert ours[key] == theirs[key], key


@pytest.fixture(scope="module")
def measurements(prepared):
    workdir, args, _ = prepared
    config = proof.configuration()
    lazy = [LazyCatalog(workdir / f"cache_{name}") for name in proof.NAMES]
    tracing.reset()
    (ours,) = crosscorrelate(config, lazy[0], lazy[1], ref_rand=lazy[2],
                             max_resident_patches=args.resident, device="cpu")
    our_totals = {"num_block_pairs": tracing.counters["blocked.block_pairs"],
                  "candidate_pairs": tracing.counters["engine.candidate_pairs"]}

    from yet_another_wizz_tpu.config import Configuration as JaxConfiguration

    jax_config = JaxConfiguration.create(
        rmin=100, rmax=1000, unit="kpc", zmin=0.15, zmax=1.0, num_bins=11
    )
    jax_lazy = [JaxLazyCatalog(workdir / f"jax_{name}") for name in proof.NAMES]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YAWT_LANE_ENCODING", "float")
        jax_blocked.reset_phase_totals()
        (theirs,) = jax_crosscorrelate(
            jax_config, jax_lazy[0], jax_lazy[1], ref_rand=jax_lazy[2],
            backend="xla", mesh="single", max_resident_patches=args.resident,
        )
        their_totals = dict(jax_blocked.PHASE_TOTALS)
    return ours, theirs, our_totals, their_totals


def test_block_plan_equals_jax(measurements):
    _, _, ours, theirs = measurements
    assert ours["num_block_pairs"] == theirs["num_block_pairs"] > 0
    assert ours["candidate_pairs"] == theirs["candidate_pairs"] > 0


@pytest.mark.parametrize("count", ["dd", "rd"])
def test_blocked_counts_equal_jax(measurements, count):
    ours, theirs, _, _ = measurements
    for part in ("counts", "sum_weights"):
        actual = np.asarray(getattr(getattr(ours, count), part).get_array())
        desired = np.asarray(getattr(getattr(theirs, count), part).get_array())
        assert_allclose(actual, desired, rtol=RTOL, atol=RTOL * np.abs(desired).max())


def test_nz_equals_jax(measurements):
    ours, theirs, _, _ = measurements
    nz_ours = RedshiftData.from_corrfuncs(ours)
    nz_theirs = JaxRedshiftData.from_corrfuncs(theirs)
    assert np.all(np.isfinite(nz_ours.data))
    for part in ("data", "error"):
        actual, desired = getattr(nz_ours, part), getattr(nz_theirs, part)
        assert_allclose(actual, desired, rtol=RTOL, atol=RTOL * np.abs(desired).max())


ON_EDGE_PAIRS = {
    # the two pairs of the 1e8-row proof's stride-64 downsample that the
    # port's engine counts and the float64 oracle does not (ROADMAP F2,
    # found by scripts/torch_proof_edge_pairs.py): row point, column point
    # (unit vectors), their weights, the edge (radian) and its float32
    # chord^2 threshold
    "DD bin 3": (
        [0.5515594900562171, 0.8330374514771801, 0.0427870700718016],
        [0.5520141159220122, 0.8327702501257175, 0.04212037901524529],
        0.6242371797561646, 1.5406016111373901, 0.000850034246737944, 7.225581839520601e-07,
    ),
    "RD bin 9": (
        [0.6476749996794577, 0.7502490200520784, -0.13282884739810952],
        [0.6479012103603559, 0.7499668018571155, -0.13331848231133048],
        1.0, 1.1792454719543457, 0.0006087369827415576, 3.705607127812982e-07,
    ),
}
"""Both lie outside their edge by less than float32 resolution. The JAX
package's XLA engine counts the DD pair too and the RD pair not (XLA may
fuse the chord's multiply-adds, which the port's kernels do not), so
which on-edge pairs flip differs between the packages."""


@pytest.mark.parametrize("name", sorted(ON_EDGE_PAIRS))
def test_on_edge_pairs_of_the_1e8_downsample(name):
    """Each pair lies outside its edge by < 1e-7 of the chord^2: the float64
    oracle does not count it, the port's audited count agrees, and the
    unaudited float32 counts of both packages are those recorded in
    ROADMAP F2 (the port counts both pairs, the JAX package's XLA engine
    only the DD pair)."""
    from yet_another_wizz_tpu.ops.linkage import TilePairs as JaxTilePairs
    from yet_another_wizz_tpu.ops.paircount import count_pairs_tiles as jax_count
    from yet_another_wizz_tpu.ops.tiles import build_tile_set as jax_tile_set
    from yet_another_wizz_tpu_torch.ops.linkage import TilePairs
    from yet_another_wizz_tpu_torch.ops.paircount import count_pairs_tiles
    from yet_another_wizz_tpu_torch.ops.tiles import build_tile_set

    xyz1, xyz2, w1, w2, edge, threshold = ON_EDGE_PAIRS[name]
    xyz1, xyz2 = np.array([xyz1]), np.array([xyz2])
    chord2 = float(np.sum((xyz1 - xyz2) ** 2))
    edge_chord2 = (2 * np.sin(edge / 2)) ** 2
    assert 0 < chord2 / edge_chord2 - 1 < 1e-7
    table = np.array([[0.0, threshold]], np.float32)
    edges = np.array([[0.0, edge]])
    one = dict(tile1=np.zeros(1, np.int32), tile2=np.zeros(1, np.int32),
               slot=np.zeros(1, np.int32), slot_patches=np.zeros((1, 2), int))
    counts = {}
    for label, build, pairs, count, kwargs in (
        ("port", build_tile_set, TilePairs, count_pairs_tiles, dict(device="cpu")),
        ("port audited", build_tile_set, TilePairs, count_pairs_tiles,
         dict(device="cpu", audit=True, edges_radian=edges)),
        ("oracle", build_tile_set, TilePairs, count_pairs_tiles,
         dict(backend="oracle", edges_radian=edges, device="cpu")),
        ("jax xla", jax_tile_set, JaxTilePairs, jax_count, dict(backend="xla", mesh="single")),
    ):
        tiles1 = build(xyz1, np.zeros(1, int), 1, weights=np.array([w1]),
                       zbins=np.zeros(1, int), num_bins=1, tile_size=128)
        tiles2 = build(xyz2, np.zeros(1, int), 1, weights=np.array([w2]), tile_size=128)
        counts[label] = float(np.asarray(count(tiles1, tiles2, pairs(**one), table, **kwargs))[0, 0, 1])
    weight = float(np.float32(np.float32(w1) * np.float32(w2)))
    assert counts["oracle"] == counts["port audited"] == 0.0
    assert counts["port"] == pytest.approx(weight, rel=1e-6)
    assert counts["jax xla"] == (pytest.approx(weight, rel=1e-6) if name.startswith("DD") else 0.0)
