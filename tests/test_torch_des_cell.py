"""The DES Y3 source-bin calibration on the CPU, and the chunk skip's
counters of the cumulative counts.

- The benchmark configuration ``des_y3_redmagic`` with its traffic
  ``single_refcorr`` (the cell ``des_y3_redmagic.single_refcorr``), cut to
  the sizes at which ``benchmark/tests/conftest.py`` runs every
  configuration on the CPU, runs through the harness's
  :class:`~harness.session.Session` (the program's ``Catalog.from_arrays``,
  ``crosscorrelate``, ``autocorrelate`` and ``RedshiftData``) and passes the
  harness's check against its plain float64 reference, at the
  configuration's scale, binning and limits.
- ``engine.chunk_blocks`` counts tile pairs times ``(T / 32)^2`` per launch
  of the cumulative kernel, and ``engine.chunk_blocks_kept`` the blocks of
  :func:`~yet_another_wizz_tpu_torch.ops.paircount.chunk_keep_mask`, the
  skip rule's plain mirror, for a cross count and a binned autocorrelation
  count at the configuration's reach, in both plain engines, and over two
  launches' groups of edges.
- Counting the blocks moves no count: the measurement's counts, sums of
  weights, n(z) and covariance are bit for bit the same with the plain
  mirror's count taken out, and a count's slots are bit for bit the plain
  kernel's (``partial_counts_torch`` and ``segment_sum_torch``, which count
  nothing).
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (one torch thread per test process)
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_skip_counter_cases import CONFIG, count_inputs, field_catalog
from yet_another_wizz_tpu_torch.config import Configuration
from yet_another_wizz_tpu_torch.correlation.measurements import (
    autocorrelate,
    crosscorrelate,
)
from yet_another_wizz_tpu_torch.ops import paircount
from yet_another_wizz_tpu_torch.ops.paircount import (
    chunk_keep_mask,
    count_pairs_tiles,
    partial_counts_torch,
    segment_sum_torch,
)
from yet_another_wizz_tpu_torch.ops.tiles import chunk_caps
from yet_another_wizz_tpu_torch.redshifts import RedshiftData
from yet_another_wizz_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
CELL = "des_y3_redmagic.single_refcorr"


@pytest.fixture(scope="module")
def bench():
    """The benchmark's test set-up (its ``TINY`` sizes; it puts the
    harness on the path)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_tests_conftest", ROOT / "benchmark" / "tests" / "conftest.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("seed", [2**33 + 20, 3_000_020_001])
def test_the_cell_passes_the_check_on_the_cpu(bench, seed):
    from harness import check, inputs
    from harness.registry import Registry
    from harness.session import Session, Spans, extract

    cell = Registry(ROOT).cell(CELL)
    config = dict(cell.config, **bench.TINY)
    assert config["binning"] == {"zmin": 0.15, "zmax": 0.89, "num_bins": 37}
    assert config["scales"][cell.traffic["scales"]] == {
        "rmin": 1.5, "rmax": 5.0, "unit": "Mpc"}
    data = inputs.make_inputs(config, seed)
    session = Session(config, cell.traffic, data, "cpu", Spans())
    session.setup()
    tracing.reset()
    actual = extract(session.measure(), cell.traffic)
    blocks = tracing.counters["engine.chunk_blocks"]
    assert 0 < tracing.counters["engine.chunk_blocks_kept"] < blocks
    desired, works = check.reference_measurement(
        config, cell.traffic, data, "cpu", bands=(cell.limits["edge_band"],))
    assert {work["count"] for work in works} == {
        "cross_dd", "cross_rd", "auto_dd", "auto_dr", "auto_rr"}
    assert all(work["pairs_in_reach"] > 0 for work in works)
    numbers = check.compare(actual, desired, cell.limits)
    assert check.judge(numbers, cell.limits), numbers


def mirror_kept(tiles1, tiles2, pairs, table, cols_binned) -> int:
    lanes1, lanes2 = tiles1.device_data("cpu"), tiles2.device_data("cpu")
    kept = 0
    for edge0 in range(0, table.shape[1], paircount.MAX_EDGES_PER_LAUNCH):
        kept += int(chunk_keep_mask(
            lanes1, chunk_caps(lanes1), chunk_caps(lanes2),
            torch.from_numpy(pairs.tile1), torch.from_numpy(pairs.tile2),
            torch.tensor(table[:, edge0:edge0 + paircount.MAX_EDGES_PER_LAUNCH]),
            cols_binned=cols_binned,
        ).sum())
    return kept


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("kind", ["cross", "auto"])
def test_kept_blocks_are_the_mirrors_sum(kind, backend):
    tiles1, tiles2, pairs, table, cols_binned = count_inputs(kind)
    table = np.asarray(table, np.float32)
    tracing.reset()
    count_pairs_tiles(tiles1, tiles2, pairs, table, backend=backend, device="cpu")
    blocks = tracing.counters["engine.chunk_blocks"]
    kept = tracing.counters["engine.chunk_blocks_kept"]
    assert table.shape[1] == 2
    assert blocks == pairs.num_pairs * 256
    assert kept == mirror_kept(tiles1, tiles2, pairs, table, cols_binned)
    assert 0 < kept < blocks


def test_kept_blocks_over_two_launches():
    """A table of 20 edges takes two launches, each deciding on every block
    with its own group's reach."""
    tiles1, tiles2, pairs, table, _ = count_inputs(
        "cross", region=(10.0, 11.5, -0.75, 0.75)
    )
    wide = np.concatenate(
        [table * f for f in np.linspace(0.2, 1.0, 10)], axis=1
    ).astype(np.float32)
    wide.sort(axis=1)
    tracing.reset()
    count_pairs_tiles(tiles1, tiles2, pairs, wide, device="cpu")
    assert wide.shape[1] == 20
    assert tracing.counters["engine.chunk_blocks"] == 2 * pairs.num_pairs * 256
    first = mirror_kept(tiles1, tiles2, pairs, wide[:, :16], False)
    assert tracing.counters["engine.chunk_blocks_kept"] == mirror_kept(
        tiles1, tiles2, pairs, wide, False)
    assert tracing.counters["engine.chunk_blocks_kept"] > first


def measure(rng_seed):
    rng = np.random.default_rng(rng_seed)
    region = (10.0, 13.0, -1.5, 1.5)
    reference = field_catalog(rng, "reference", region, device="cpu", patch_num=4)
    unknown = field_catalog(rng, "unknown", region, device="cpu",
                            patch_centers=reference)
    randoms = field_catalog(rng, "reference", region, device="cpu",
                            patch_centers=reference)
    config = Configuration.create(**CONFIG)
    cross = crosscorrelate(config, reference, unknown, ref_rand=randoms, device="cpu")
    auto = autocorrelate(config, reference, randoms, device="cpu")
    arrays = []
    for corr in (*cross, *auto):
        for kind in ("dd", "dr", "rd", "rr"):
            counts = getattr(corr, kind, None)
            if counts is not None:
                arrays += [np.asarray(counts.counts.counts),
                           np.asarray(counts.sum_weights.sum_weights1),
                           np.asarray(counts.sum_weights.sum_weights2)]
    nz = RedshiftData.from_corrfuncs(cross[0], ref_corr=auto[0])
    return arrays + [np.asarray(nz.data), np.asarray(nz.covariance)]


def test_counting_blocks_moves_no_count(monkeypatch):
    tracing.reset()
    counted = measure(7)
    assert tracing.counters["engine.chunk_blocks_kept"] > 0
    # the same measurement with the plain engines' count taken out
    monkeypatch.setattr(
        paircount, "count_chunk_blocks_plain", lambda *a, **k: None
    )
    tracing.reset()
    uncounted = measure(7)
    assert "engine.chunk_blocks_kept" not in tracing.counters
    assert len(counted) == len(uncounted) == 17
    for a, b in zip(counted, uncounted):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("kind", ["cross", "auto"])
def test_counted_slots_are_the_plain_kernels(kind, backend):
    tiles1, tiles2, pairs, table, cols_binned = count_inputs(
        kind, region=(10.0, 11.5, -0.75, 0.75)
    )
    table = np.asarray(table, np.float32)
    tracing.reset()
    counts = count_pairs_tiles(
        tiles1, tiles2, pairs, table, backend=backend, device="cpu"
    )
    assert tracing.counters["engine.chunk_blocks_kept"] > 0
    partial = partial_counts_torch(
        tiles1.device_data("cpu"), tiles2.device_data("cpu"),
        torch.from_numpy(pairs.tile1).long(), torch.from_numpy(pairs.tile2).long(),
        torch.tensor(table), cols_binned=cols_binned,
    )
    plain = segment_sum_torch(
        partial, torch.from_numpy(pairs.slot).long(), pairs.num_slots
    ).numpy()
    assert counts.tobytes() == plain.astype(np.float64).tobytes()
