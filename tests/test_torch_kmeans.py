"""Patch assignment of the port takes its device from the caller.

Above ``DEVICE_ASSIGN_THRESHOLD`` points x centers, ``assign_patches``
scores the points in float64 on the caller's device (default ``"cuda"``),
with the host path's operations, so both assign every point alike; without
a card that default raises instead of running on the CPU. Below the
threshold the host path runs, as in the JAX package.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from yet_another_wizz_tpu_torch.catalog import Catalog
from yet_another_wizz_tpu_torch.ops import kmeans


@pytest.fixture
def points():
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(4000, 3))
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    centers = xyz[rng.choice(len(xyz), 16, replace=False)]
    return xyz, centers


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_device_assignment_on_cpu_matches_host(monkeypatch, points):
    xyz, centers = points
    host = kmeans.assign_patches(xyz, centers)
    monkeypatch.setattr(kmeans, "DEVICE_ASSIGN_THRESHOLD", 1)
    on_device = kmeans.assign_patches(xyz, centers, device="cpu", chunk=1000)
    assert_array_equal(on_device, host)
    monkeypatch.setattr(kmeans, "DEVICE_SCORES", 100)  # steps within a chunk
    assert_array_equal(
        kmeans.assign_patches(xyz, centers, device="cpu", chunk=1000), host
    )


def test_device_assignment_defaults_to_cuda(monkeypatch, points, no_cuda):
    xyz, centers = points
    assert_array_equal(
        kmeans.assign_patches(xyz, centers),  # host path: below threshold
        kmeans.assign_patches(xyz, centers, device="cpu"),
    )
    monkeypatch.setattr(kmeans, "DEVICE_ASSIGN_THRESHOLD", 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kmeans.assign_patches(xyz, centers)


def test_catalog_passes_its_device(monkeypatch, no_cuda):
    rng = np.random.default_rng(3)
    ra = rng.uniform(0.0, 1.0, 3000)
    dec = rng.uniform(-0.5, 0.5, 3000)
    monkeypatch.setattr(kmeans, "DEVICE_ASSIGN_THRESHOLD", 1)
    catalog = Catalog.from_arrays(ra, dec, degrees=False, patch_num=4, device="cpu")
    assert catalog.num_patches == 4
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Catalog.from_arrays(ra, dec, degrees=False, patch_num=4)
