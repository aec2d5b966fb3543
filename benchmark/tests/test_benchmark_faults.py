"""A whole run on the CPU with the timed path broken underneath comes out
not correct: a count altered where it is produced, half of the patch pairs
left out with the rest doubled (the total kept), and an n(z) altered where
it is produced. The cells run on one card, so no exchange between cards can
be left out, and no state is carried from step to step."""

import numpy as np
import pytest

from conftest import cpu_run


def alter_one_count(monkeypatch):
    from yet_another_wizz_tpu_torch.correlation import measurements

    original = measurements.count_pairs_tiles

    def altered(*args, **kwargs):
        result = original(*args, **kwargs)
        result = result if isinstance(result, np.ndarray) else result.clone()
        flat = result.reshape(-1)  # a view: the largest count is altered
        flat[int(abs(flat).argmax())] *= 1.01
        return result

    monkeypatch.setattr(measurements, "count_pairs_tiles", altered)


def drop_half(monkeypatch):
    from yet_another_wizz_tpu_torch.correlation import measurements

    original = measurements.count_pairs_tiles

    def halved(*args, **kwargs):
        result = original(*args, **kwargs)
        result = result if isinstance(result, np.ndarray) else result.clone()
        result[1::2] = 0
        result[0::2] *= 2
        return result

    monkeypatch.setattr(measurements, "count_pairs_tiles", halved)


def alter_nz(monkeypatch):
    from yet_another_wizz_tpu_torch.redshifts import RedshiftData

    original = RedshiftData.from_corrdata.__func__

    def altered(cls, *args, **kwargs):
        nz = original(cls, *args, **kwargs)
        return cls(nz.binning, nz.data * 1.001, nz.samples, method=nz.method)

    monkeypatch.setattr(RedshiftData, "from_corrdata", classmethod(altered))


@pytest.mark.parametrize("fault", [alter_one_count, drop_half, alter_nz])
def test_fault_is_caught(tiny_root, tmp_path, monkeypatch, fault):
    assert cpu_run(tiny_root, "inmem_mock.multiscale", tmp_path)["correct"] is True
    fault(monkeypatch)
    result = cpu_run(tiny_root, "inmem_mock.multiscale", tmp_path)
    assert result["correct"] is False
    assert any(entry["value"] > entry["limit"] for entry in result["checks"].values())
