"""The benchmark's inputs, made from the seed: mock catalogs and the patch
centres.

Plain NumPy; nothing here imports the program, so that a change to the
program cannot move what it is measured on.

- :func:`mock_catalogs` follows ``examples.generate_mock_data`` of
  ``yet_another_wizz_tpu_torch/examples/__init__.py`` (galaxies scattered
  around shared clusters, randoms drawing the reference's redshifts), with
  its clustering set to a published correlation function instead of
  invented clusters. Galaxies and clusters are uniform in comoving volume;
  a share ``cluster_fraction`` of each sample belongs to clusters, each
  cluster's members scatter with a comoving size drawn so that the sizes
  together give a power-law projected correlation ``w_p(r_p)`` of
  ``xi(r) = (r / r0)^-gamma``, and the number of clusters sets its
  amplitude (:func:`cluster_density`). The clusters come from the
  configuration's ``structure_seed``, everything else (members, field
  galaxies, weights, random points) from the run's seed: every seed
  measures the same structure, and so the same amount of work, drawn anew.
- :func:`kmeans_centers` is ``kmeans_patch_centers`` of
  ``yet_another_wizz_tpu_torch/ops/kmeans.py`` (kmeans++ seeding, Lloyd
  iterations on a probe subsample), on the host in float64; it runs on a
  reference sample drawn from the structure seed alone, so the patches are
  the same for every seed.
"""

from __future__ import annotations

import math

import numpy as np

from harness.cosmo import Planck15

SIZE_GRID = 4096
"""Points of the quadrature over cluster sizes."""


def _trapezoid(values, grid, axis=-1):
    values = np.moveaxis(values, axis, -1)
    return (0.5 * (values[..., 1:] + values[..., :-1]) * np.diff(grid)).sum(-1)


def radec_to_xyz(ra, dec):
    cos_dec = np.cos(dec)
    return np.stack([cos_dec * np.cos(ra), cos_dec * np.sin(ra), np.sin(dec)], 1)


def xyz_to_radec(xyz):
    ra = np.mod(np.arctan2(xyz[:, 1], xyz[:, 0]), 2.0 * np.pi)
    dec = np.arcsin(np.clip(xyz[:, 2], -1.0, 1.0))
    return ra, dec


def _uniform_sky(rng, n, region):
    ra_min, ra_max, dec_min, dec_max = np.deg2rad(np.asarray(region, float))
    ra = rng.uniform(ra_min, ra_max, n)
    sin_dec = rng.uniform(np.sin(dec_min), np.sin(dec_max), n)
    return ra, np.arcsin(sin_dec)


def solid_angle(region) -> float:
    ra_min, ra_max, dec_min, dec_max = np.deg2rad(np.asarray(region, float))
    return float((ra_max - ra_min) * (np.sin(dec_max) - np.sin(dec_min)))


def _scatter_on_sky(rng, centers_xyz, sigma_rad):
    """Displace unit vectors by Gaussian angular offsets."""
    offsets = rng.normal(0.0, 1.0, (len(centers_xyz), 2)) * sigma_rad[:, None]
    east = np.cross(np.array([0.0, 0.0, 1.0]), centers_xyz)
    east /= np.maximum(np.linalg.norm(east, axis=1, keepdims=True), 1e-12)
    north = np.cross(centers_xyz, east)
    displaced = centers_xyz + offsets[:, :1] * east + offsets[:, 1:] * north
    return displaced / np.linalg.norm(displaced, axis=1, keepdims=True)


class _Volume:
    """Redshifts uniform in comoving volume over ``z_range``."""

    def __init__(self, z_range, cosmology) -> None:
        self.z = np.linspace(z_range[0], z_range[1], 2049)
        self.chi = cosmology.comoving_distance(self.z)

    def draw(self, rng, n):
        cubes = rng.uniform(self.chi[0] ** 3, self.chi[-1] ** 3, n)
        return np.interp(np.cbrt(cubes), self.chi, self.z)

    def comoving(self, z):
        return np.interp(z, self.z, self.chi)


def target_wp(mock: dict, r_mpc, cosmology=None):
    """The published projected correlation ``w_p(r_p)`` in Mpc at comoving
    ``r_mpc``: ``r (r0 / r)^gamma Gamma(1/2) Gamma((gamma - 1)/2) /
    Gamma(gamma/2)``, with ``r0`` given in Mpc/h."""
    cosmology = cosmology or Planck15()
    gamma = mock["xi_gamma"]
    r0 = mock["xi_r0_mpc_h"] / (cosmology.H0 / 100.0)
    r = np.asarray(r_mpc, dtype=np.float64)
    factor = (math.gamma(0.5) * math.gamma(0.5 * (gamma - 1.0))
              / math.gamma(0.5 * gamma))
    return r * (r0 / r) ** gamma * factor


def _sizes(mock: dict):
    """Cluster sizes ``s`` (the per-axis spread of a member pair, comoving
    Mpc) and their probability density ``~ s^(2 - gamma)``, whose Gaussian
    pair profiles sum to ``r^(1 - gamma)`` between the size limits."""
    s_lo, s_hi = mock["profile_mpc"]
    grid = np.geomspace(s_lo, s_hi, SIZE_GRID)
    pdf = grid ** (2.0 - mock["xi_gamma"])
    pdf /= _trapezoid(pdf, grid)
    return grid, pdf


def mean_pair_profile(mock: dict, r_mpc):
    """The surface density of a member pair's separation at comoving
    ``r_mpc``, averaged over the cluster sizes."""
    grid, pdf = _sizes(mock)
    r = np.atleast_1d(np.asarray(r_mpc, dtype=np.float64))[:, None]
    profile = np.exp(-0.5 * (r / grid) ** 2) / (2.0 * np.pi * grid**2)
    return _trapezoid(pdf * profile, grid, axis=1)


def cluster_density(mock: dict, cosmology=None) -> float:
    """Clusters per comoving Mpc^3 that give the target ``w_p``.

    Members of one cluster, drawn with equal probability among the clusters
    of a redshift slice, add ``f^2 <p(r)> / n_c`` to ``w_p(r)``, with ``f``
    the clustered share and ``<p>`` the mean pair profile. The density is
    fitted, pair-weighted, over comoving ``match_mpc``, the scales the
    cells count."""
    lo, hi = mock["match_mpc"]
    r = np.geomspace(lo, hi, 256)
    weights = r**2  # pairs per log interval of r
    ratio = np.sum(weights * mean_pair_profile(mock, r)) / np.sum(
        weights * target_wp(mock, r, cosmology))
    return mock["cluster_fraction"] ** 2 * ratio


def mock_catalogs(mock: dict, num_reference: int, num_unknown: int,
                  num_randoms: int, seed: int) -> dict:
    """Reference and unknown galaxies around shared clusters, and uniform
    randoms over the region drawing the reference's redshifts (none with
    ``num_randoms`` 0). ``mock`` holds the generator's parameters. Returns
    ``{name: {"ra", "dec", "redshifts", "weights"}}`` in radian."""
    cosmology = Planck15()
    structure = np.random.default_rng(mock["structure_seed"])
    rng = np.random.default_rng(seed)
    region = mock["region_deg"]
    z_lo, z_hi = mock["z_range"]
    volume = _Volume(mock["z_range"], cosmology)
    comoving_volume = solid_angle(region) / 3.0 * (volume.chi[-1] ** 3 - volume.chi[0] ** 3)
    num_clusters = int(round(cluster_density(mock, cosmology) * comoving_volume))

    cluster_ra, cluster_dec = _uniform_sky(structure, num_clusters, region)
    cluster_xyz = radec_to_xyz(cluster_ra, cluster_dec)
    cluster_z = volume.draw(structure, num_clusters)
    grid, pdf = _sizes(mock)
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (pdf[1:] + pdf[:-1]) * np.diff(grid))])
    sizes = np.interp(structure.uniform(0.0, cdf[-1], num_clusters), cdf, grid)
    # per-axis member spread: a pair of members spreads by ``size``
    cluster_sigma = sizes / np.sqrt(2.0) / volume.comoving(cluster_z)

    def make_sample(n):
        num_clustered = int(n * mock["cluster_fraction"])
        members = rng.integers(0, num_clusters, num_clustered)
        xyz = _scatter_on_sky(rng, cluster_xyz[members], cluster_sigma[members])
        z_clustered = np.clip(
            cluster_z[members]
            + rng.normal(0, mock["redshift_sigma"], num_clustered),
            z_lo, z_hi,
        )
        ra_field, dec_field = _uniform_sky(rng, n - num_clustered, region)
        ra_cl, dec_cl = xyz_to_radec(xyz)
        ra = np.concatenate([ra_cl, ra_field])
        dec = np.concatenate([dec_cl, dec_field])
        redshifts = np.concatenate(
            [z_clustered, volume.draw(rng, n - num_clustered)]
        )
        order = rng.permutation(n)
        return dict(ra=ra[order], dec=dec[order], redshifts=redshifts[order],
                    weights=rng.uniform(0.5, 2.0, n))

    catalogs = dict(reference=make_sample(num_reference),
                    unknown=make_sample(num_unknown))
    if num_randoms:
        ra, dec = _uniform_sky(rng, num_randoms, region)
        catalogs["randoms"] = dict(
            ra=ra, dec=dec,
            redshifts=rng.choice(catalogs["reference"]["redshifts"], num_randoms),
            weights=np.ones(num_randoms),
        )
    return catalogs


# -- patch centres -----------------------------------------------------------

def kmeans_centers(xyz, num_patches: int, *, probe_size: int, seed: int,
                   iterations: int = 30):
    """``num_patches`` unit vectors from kmeans++ seeding and Lloyd
    iterations on a probe subsample of ``xyz`` (unweighted)."""
    rng = np.random.default_rng(seed)
    if probe_size < len(xyz):
        xyz = xyz[rng.choice(len(xyz), probe_size, replace=False)]
    centers = np.empty((num_patches, 3))
    centers[0] = xyz[rng.integers(len(xyz))]
    min_d2 = np.full(len(xyz), np.inf)
    for idx in range(1, num_patches):
        np.minimum(min_d2, ((xyz - centers[idx - 1]) ** 2).sum(1), out=min_d2)
        centers[idx] = xyz[rng.choice(len(xyz), p=min_d2 / min_d2.sum())]
    for _ in range(iterations):
        labels = nearest_center(xyz, centers)
        sums = np.stack([np.bincount(labels, weights=xyz[:, d],
                                     minlength=num_patches) for d in range(3)], 1)
        norms = np.linalg.norm(sums, axis=1)
        update = norms > 0
        centers[update] = sums[update] / norms[update, None]
    return centers / np.linalg.norm(centers, axis=1, keepdims=True)


def nearest_center(xyz, centers, chunk: int = 1 << 18):
    """Index of the centre with the greatest dot product, in float64."""
    out = np.empty(len(xyz), dtype=np.int64)
    for start in range(0, len(xyz), chunk):
        block = xyz[start:start + chunk]
        scores = block[:, 0, None] * centers[:, 0]
        scores += block[:, 1, None] * centers[:, 1]
        scores += block[:, 2, None] * centers[:, 2]
        out[start:start + chunk] = np.argmax(scores, axis=1)
    return out


def make_inputs(config: dict, seed: int) -> dict:
    """The catalogs and patch centres of one run of ``config``:
    ``{"catalogs": {name: columns}, "centers": (P, 3)}``."""
    mock = dict(config["mock"], region_deg=config["region_deg"])
    catalogs = mock_catalogs(mock, config["num_reference"], config["num_unknown"],
                             config["num_randoms"], seed)
    # the centres come from the fixed structure alone, so that every seed
    # measures the same patches (and so the same amount of work and memory)
    probe = mock_catalogs(mock, config["kmeans_probe"], 0, 0,
                          mock["structure_seed"])["reference"]
    centers = kmeans_centers(
        radec_to_xyz(probe["ra"], probe["dec"]), config["num_patches"],
        probe_size=config["kmeans_probe"], seed=mock["structure_seed"],
    )
    return dict(catalogs=catalogs, centers=centers)
