"""The port's HEALPix functions and random generators against the JAX
package's: the same inputs give the same pixels and angles, and the same
seed draws the same points (both are numpy code, so equality is exact)."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
from numpy.testing import assert_array_equal

from yet_another_wizz_tpu import randoms as jax_randoms
from yet_another_wizz_tpu.utils import healpix as jax_healpix
from yet_another_wizz_tpu_torch import randoms
from yet_another_wizz_tpu_torch.utils import healpix

NSIDES = [1, 4, 128]


@pytest.mark.parametrize("nside", NSIDES)
def test_healpix_functions_equal_jax(nside):
    rng = np.random.default_rng(nside)
    theta = np.arccos(rng.uniform(-1.0, 1.0, 5000))
    phi = rng.uniform(0.0, 2.0 * np.pi, 5000)
    npix = healpix.nside_to_npix(nside)
    assert npix == jax_healpix.nside_to_npix(nside)
    assert healpix.npix_to_nside(npix) == nside
    pix = healpix.ang2pix_ring(nside, theta, phi)
    assert_array_equal(pix, jax_healpix.ang2pix_ring(nside, theta, phi))
    every = np.arange(npix)
    for ours, theirs in zip(
        healpix.pix2ang_ring(nside, every), jax_healpix.pix2ang_ring(nside, every)
    ):
        assert_array_equal(ours, theirs)
    for ours, theirs in zip(
        healpix.pix_bounds_ring(nside, every),
        jax_healpix.pix_bounds_ring(nside, every),
    ):
        assert_array_equal(ours, theirs)
    # every pixel center maps back to its own pixel
    assert_array_equal(healpix.ang2pix_ring(nside, *healpix.pix2ang_ring(nside, every)), every)


def test_healpix_rejects_bad_input():
    with pytest.raises(ValueError, match="invalid number"):
        healpix.npix_to_nside(100)
    with pytest.raises(ValueError, match="out of range"):
        healpix.pix2ang_ring(2, [48])


def survey_mask(nside):
    """The survey path's footprint: 40-60 deg in ra, -10-10 deg in dec."""
    colat, lon = healpix.pix2ang_ring(nside, np.arange(12 * nside * nside))
    ra, dec = np.rad2deg(lon), 90.0 - np.rad2deg(colat)
    return ((ra >= 40) & (ra <= 60) & (dec >= -10) & (dec <= 10)).astype(float)


@pytest.mark.parametrize("attached", ["none", "weights", "redshifts", "both"])
@pytest.mark.parametrize("kind", ["box", "healpix"])
def test_draws_equal_jax(kind, attached):
    rng = np.random.default_rng(3)
    values = dict(weights=rng.uniform(0.5, 2, 300), redshifts=rng.uniform(0.1, 1, 300))
    kwargs = {
        name: value for name, value in values.items()
        if attached in (name, "both")
    }
    if kind == "box":
        args = (10.0, 40.0, -20.0, 5.0)
        ours = randoms.BoxRandoms(*args, seed=199, **kwargs)
        theirs = jax_randoms.BoxRandoms(*args, seed=199, **kwargs)
    else:
        mask = survey_mask(16)
        ours = randoms.HealPixRandoms(mask, seed=199, **kwargs)
        theirs = jax_randoms.HealPixRandoms(mask, seed=199, **kwargs)
    for size in (1000, 2500):  # two draws: the generator state advances alike
        chunk, expected = ours(size), theirs(size)
        assert chunk.dtype.names == expected.dtype.names
        for name in expected.dtype.names:
            assert_array_equal(chunk[name], expected[name])
    if kind == "healpix":
        pix = healpix.ang2pix_ring(16, np.pi / 2 - chunk["dec"], chunk["ra"])
        assert np.all(mask[pix] > 0)
    ours.reseed(5)
    theirs.reseed(5)
    assert_array_equal(ours(10)["ra"], theirs(10)["ra"])


def test_generators_reject_bad_input():
    with pytest.raises(ValueError, match="ra_min"):
        randoms.BoxRandoms(10.0, 10.0, 0.0, 1.0)
    with pytest.raises(ValueError, match="no area"):
        randoms.HealPixRandoms(np.zeros(12))
    with pytest.raises(ValueError, match="does not match"):
        randoms.BoxRandoms(0.0, 1.0, 0.0, 1.0, weights=np.ones(3), redshifts=np.ones(4))
