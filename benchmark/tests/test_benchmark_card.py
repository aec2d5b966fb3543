"""On the card: a cell cut to a test's size runs end to end, with the
kernels, and comes out correct with every metric read (skipped without a
card; run on the chip with ``python -m pytest benchmark/tests -m gpu``)."""

import types
import time

import pytest

from conftest import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with the CUDA toolkit")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, tiny_root, tmp_path, trace):
    from harness.registry import Registry
    from harness.runner import run

    args = types.SimpleNamespace(workload="inmem_mock.multiscale", seed=2**34 + 9,
                                 seconds=1.0, trace=trace, out=str(tmp_path))
    result = run(args, ROOT, time.time(), device=card, registry=Registry(tiny_root))
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    cell = Registry(tiny_root).cell("inmem_mock.multiscale")
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert names == set(result["metrics"])
