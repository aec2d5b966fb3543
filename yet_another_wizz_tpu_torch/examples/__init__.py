"""Deterministic mock survey data for tests and the chip smoke run.

The same generator as the JAX package's ``examples.generate_mock_data``:
reference and unknown galaxies are scattered around shared "cluster"
positions so both samples trace the same large-scale structure and the
recovered n(z) is meaningful. Given the same seed, both packages produce
identical arrays (plain numpy, one ``numpy.random.Generator``).

The prepared-survey accessors and precomputed products of the JAX package
are not part of this package yet.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.coordinates import radec_to_xyz, xyz_to_radec
from yet_another_wizz_tpu_torch.cosmology import get_default_cosmology

if TYPE_CHECKING:
    from numpy.typing import NDArray

__all__ = [
    "generate_mock_data",
]

DEFAULT_REGION = (40.0, 60.0, -10.0, 10.0)  # ra_min, ra_max, dec_min, dec_max
DEFAULT_Z_RANGE = (0.15, 1.0)


def _uniform_sky(rng, n, region):
    ra_min, ra_max, dec_min, dec_max = np.deg2rad(np.asarray(region, float))
    ra = rng.uniform(ra_min, ra_max, n)
    sin_dec = rng.uniform(np.sin(dec_min), np.sin(dec_max), n)
    return ra, np.arcsin(sin_dec)


def _scatter_on_sky(rng, centers_xyz, sigma_rad):
    """Displace unit vectors by Gaussian angular offsets."""
    n = len(centers_xyz)
    # local tangent-plane offsets
    offsets = rng.normal(0.0, 1.0, (n, 2)) * sigma_rad[:, None]
    # build tangent bases
    z_axis = np.array([0.0, 0.0, 1.0])
    east = np.cross(z_axis, centers_xyz)
    east /= np.maximum(np.linalg.norm(east, axis=1, keepdims=True), 1e-12)
    north = np.cross(centers_xyz, east)
    displaced = (
        centers_xyz + offsets[:, :1] * east + offsets[:, 1:] * north
    )
    return displaced / np.linalg.norm(displaced, axis=1, keepdims=True)


def generate_mock_data(
    num_reference: int = 20_000,
    num_unknown: int = 50_000,
    num_randoms: int = 100_000,
    *,
    num_clusters: int = 800,
    cluster_fraction: float = 0.65,
    cluster_sigma_kpc: float = 450.0,
    redshift_sigma: float = 0.015,
    region: tuple[float, float, float, float] = DEFAULT_REGION,
    z_range: tuple[float, float] = DEFAULT_Z_RANGE,
    weighted: bool = True,
    seed: int = 12345,
) -> dict[str, dict[str, NDArray]]:
    """Generate a deterministic mock survey with clustering signal.

    Galaxies of both samples are placed around shared cluster positions
    (physical scatter ``cluster_sigma_kpc`` converted to an angle at the
    cluster redshift) with the remainder uniform on the sky, producing
    positive cross- and autocorrelation amplitudes at ~Mpc scales.

    Returns a dictionary with keys ``reference``, ``unknown``, ``randoms``;
    each value holds ``ra``/``dec`` (radian) plus ``redshifts`` and
    (optionally) ``weights`` arrays.
    """
    rng = np.random.default_rng(seed)
    cosmology = get_default_cosmology()
    z_lo, z_hi = z_range

    # shared large-scale structure
    cluster_ra, cluster_dec = _uniform_sky(rng, num_clusters, region)
    cluster_xyz = radec_to_xyz(cluster_ra, cluster_dec)
    cluster_z = rng.uniform(z_lo, z_hi, num_clusters)
    richness = rng.pareto(2.5, num_clusters) + 1.0
    cluster_prob = richness / richness.sum()
    # angular scatter of members at the cluster redshift
    ang_diam = cosmology.angular_diameter_distance(cluster_z)
    cluster_sigma = (cluster_sigma_kpc / 1000.0) / np.asarray(ang_diam)

    def make_sample(n):
        num_clustered = int(n * cluster_fraction)
        members = rng.choice(num_clusters, num_clustered, p=cluster_prob)
        xyz = _scatter_on_sky(
            rng, cluster_xyz[members], cluster_sigma[members]
        )
        z_clustered = np.clip(
            cluster_z[members] + rng.normal(0, redshift_sigma, num_clustered),
            z_lo, z_hi,
        )
        ra_field, dec_field = _uniform_sky(rng, n - num_clustered, region)
        ra_cl, dec_cl = xyz_to_radec(xyz)
        ra = np.concatenate([ra_cl, ra_field])
        dec = np.concatenate([dec_cl, dec_field])
        redshifts = np.concatenate(
            [z_clustered, rng.uniform(z_lo, z_hi, n - num_clustered)]
        )
        order = rng.permutation(n)
        sample = dict(ra=ra[order], dec=dec[order], redshifts=redshifts[order])
        if weighted:
            sample["weights"] = rng.uniform(0.5, 2.0, n)
        return sample

    reference = make_sample(num_reference)
    unknown = make_sample(num_unknown)

    rand_ra, rand_dec = _uniform_sky(rng, num_randoms, region)
    randoms = dict(
        ra=rand_ra,
        dec=rand_dec,
        redshifts=rng.choice(reference["redshifts"], num_randoms, replace=True),
    )
    if weighted:
        randoms["weights"] = np.ones(num_randoms)

    return dict(reference=reference, unknown=unknown, randoms=randoms)
