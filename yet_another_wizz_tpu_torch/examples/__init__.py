"""Deterministic mock survey data for tests and the chip smoke run.

The same generator as the JAX package's ``examples.generate_mock_data``:
reference and unknown galaxies are scattered around shared "cluster"
positions so both samples trace the same large-scale structure and the
recovered n(z) is meaningful. Given the same seed, both packages produce
identical arrays (plain numpy, one ``numpy.random.Generator``).

Like the reference (yaw/examples/__init__.py:46-301), the example API
serves a prepared 2dFLenS galaxy sample with precomputed correlation
products when those files are available (``USES_REAL_DATA``; looked up via
``YAWT_EXAMPLE_DATA_DIR`` or the download cache, filled by
:meth:`ExampleData.download_and_update`). Without them the example data is
the deterministic mock, with the precomputed products committed under
``examples/products/``. Set ``YAWT_EXAMPLE_FORCE_MOCK=1`` to force the mock
even when the survey files exist. Catalogs and products that have to be
computed run on ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.coordinates import radec_to_xyz, xyz_to_radec
from yet_another_wizz_tpu_torch.cosmology import get_default_cosmology

if TYPE_CHECKING:
    from numpy.typing import NDArray

__all__ = [
    "ExampleData",
    "PATH",
    "USES_REAL_DATA",
    "config",
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


# -- reference-style example accessors ---------------------------------------

import os as _os
import tempfile as _tempfile
from pathlib import Path as _Path

from yet_another_wizz_tpu_torch.utils.misc import env_flag as _env_flag


_PACKAGE_PRODUCTS = _Path(__file__).parent / "products"
"""Precomputed products of the deterministic mock example, committed
with the package (mirroring the reference, which ships cross.hdf /
auto.hdf / estimate.{dat,smp,cov} in-package,
yaw/examples/__init__.py:46-301): a fresh offline install loads
``examples.cross/auto/estimate`` without computing. They are byte copies
of the JAX package's products (``scripts/create_example_products.py``
computes those); the formats are shared."""


def _packaged_products_dir() -> "_Path | None":
    """The committed mock products, unless absent or explicitly ignored
    (``YAWT_EXAMPLE_IGNORE_PACKAGED``, used when regenerating them)."""
    if _env_flag("YAWT_EXAMPLE_IGNORE_PACKAGED"):
        return None
    if (_PACKAGE_PRODUCTS / "cross.hdf").exists():
        return _PACKAGE_PRODUCTS
    return None


def _search_dirs() -> "list[_Path]":
    """Candidate directories for the prepared 2dFLenS files, in priority
    order: ``YAWT_EXAMPLE_DATA_DIR``, the download cache."""
    candidates = []
    if env_dir := _os.environ.get("YAWT_EXAMPLE_DATA_DIR"):
        candidates.append(_Path(env_dir))
    candidates.append(_download_target())
    return candidates


_EXPLICIT_TARGET: "_Path | None" = None
"""Custom directory passed to :meth:`ExampleData.download_and_update`,
registered so the example API finds the downloaded files there."""


def _download_target() -> "_Path":
    """Writable directory :meth:`ExampleData.download_and_update` fills."""
    if _EXPLICIT_TARGET is not None:
        return _EXPLICIT_TARGET
    if env_dir := _os.environ.get("YAWT_EXAMPLE_DATA_DIR"):
        return _Path(env_dir)
    return _example_cache() / "2dflens"


def _example_cache() -> "_Path":
    """``YAWT_EXAMPLE_CACHE``, by default ``yawt_examples`` in the system
    temporary directory."""
    return _Path(
        _os.environ.get("YAWT_EXAMPLE_CACHE")
        or _Path(_tempfile.gettempdir()) / "yawt_examples"
    )


def _find_real_data_dir() -> "_Path | None":
    """Locate the prepared 2dFLenS survey files (data/rand parquet; the
    reference bundles them next to its example module,
    yaw/examples/__init__.py:46-55, and can download them on demand —
    mirrored by :meth:`ExampleData.download_and_update`).

    The precomputed ``cross.hdf``/``auto.hdf``/``estimate.*`` products are
    optional: when absent (e.g. after a fresh download) they are computed
    locally on first access. Returns None (-> generated mock fallback)
    when no survey files are available or ``YAWT_EXAMPLE_FORCE_MOCK`` is
    set.
    """
    if _env_flag("YAWT_EXAMPLE_FORCE_MOCK"):
        return None
    required = ("2dflens_kidss_data.pqt", "2dflens_kidss_rand_5x.pqt")
    for directory in _search_dirs():
        if all((directory / name).exists() for name in required):
            return directory
    return None


class PATH:
    """Paths of the example data products.

    When the prepared 2dFLenS files are available (see
    :func:`_find_real_data_dir`) these point at the real survey data and
    the correlation products (committed alongside them, or computed into a
    writable location on first access), exactly like the reference's
    ``yaw.examples.PATH``. Otherwise they point into a writable cache
    where :class:`ExampleData` materialises a deterministic mock on
    demand.
    """

    root: "_Path"
    data: "_Path"
    rand: "_Path"
    unknown: "_Path"
    cross: "_Path"
    auto: "_Path"
    estimate: "_Path"


USES_REAL_DATA: bool = False
_REAL_DIR: "_Path | None" = None


def _refresh_paths() -> None:
    """(Re-)resolve the example data location; called at import and after
    :meth:`ExampleData.download_and_update` adds the survey files."""
    global _REAL_DIR, USES_REAL_DATA
    _REAL_DIR = _find_real_data_dir()
    USES_REAL_DATA = _REAL_DIR is not None

    PATH.root = _example_cache()
    if USES_REAL_DATA:
        PATH.data = _REAL_DIR / "2dflens_kidss_data.pqt"
        PATH.rand = _REAL_DIR / "2dflens_kidss_rand_5x.pqt"
        # the reference example uses the data sample as its own unknown
        PATH.unknown = PATH.data
        # products next to the survey files: committed ones when present,
        # else computed there on first access
        products = _REAL_DIR
        PATH.cross = products / "cross.hdf"
        PATH.auto = products / "auto.hdf"
        PATH.estimate = products / "estimate"
    else:
        PATH.data = PATH.root / "mock_data.pqt"
        PATH.rand = PATH.root / "mock_rand.pqt"
        PATH.unknown = PATH.root / "mock_unknown.pqt"
        products = _packaged_products_dir() or PATH.root
        PATH.cross = products / "cross.hdf"
        PATH.auto = products / "auto.hdf"
        PATH.estimate = products / "estimate"


_refresh_paths()


def _example_configuration():
    from yet_another_wizz_tpu_torch.config import Configuration

    return Configuration.create(
        rmin=100, rmax=1000, unit="kpc",
        zmin=0.15, zmax=0.7, num_bins=11,
    )


# note: `config`, `cross`, `auto` and `estimate` are module attributes
# resolved lazily in __getattr__ below


class ExampleData:
    """Create the example catalogs and precomputed correlation products.

    Mirrors the reference's ``yaw.examples.ExampleData``
    (yaw/examples/__init__.py:94-301). Backed by the
    prepared 2dFLenS survey files when available (``USES_REAL_DATA``, with
    the bundled ``patch`` column assigning the 11 precomputed patches),
    otherwise by a deterministically generated mock survey.
    """

    NUM_PATCHES = 11

    @classmethod
    def ensure_files(cls) -> None:
        """Materialise the example parquet files (idempotent; no-op when the
        real survey files are used)."""
        if PATH.data.exists() and PATH.rand.exists():
            return
        import numpy as np
        import pyarrow as pa
        import pyarrow.parquet as pq

        PATH.root.mkdir(parents=True, exist_ok=True)
        mock = generate_mock_data(
            num_reference=15_000, num_unknown=25_000, num_randoms=60_000,
            seed=12345,
        )
        for name, target in (
            ("reference", PATH.data),
            ("randoms", PATH.rand),
            ("unknown", PATH.unknown),
        ):
            sample = mock[name]
            pq.write_table(
                pa.table(
                    dict(
                        RA=np.rad2deg(sample["ra"]),
                        Dec=np.rad2deg(sample["dec"]),
                        redshift=sample["redshifts"],
                        wei=sample["weights"],
                    )
                ),
                target,
            )

    @classmethod
    def _default_patch_args(cls) -> dict:
        """Patch assignment: the bundled ``patch`` column for the real survey
        files (reference behaviour, examples/__init__.py:176-179), kmeans
        patches for the mock."""
        if USES_REAL_DATA:
            return dict(patch_name="patch")
        return dict(patch_num=cls.NUM_PATCHES)

    @classmethod
    def _catalog(cls, cache_directory, path, **kwargs):
        from yet_another_wizz_tpu_torch.catalog import Catalog

        cls.ensure_files()
        return Catalog.from_file(
            cache_directory, path,
            ra_name="RA", dec_name="Dec", redshift_name="redshift",
            weight_name="wei", overwrite=True, **kwargs,
        )

    @classmethod
    def create_data_cat(cls, cache_directory=None, **kwargs):
        """The example reference data catalog."""
        return cls._catalog(
            cache_directory, PATH.data, **cls._default_patch_args(), **kwargs
        )

    @classmethod
    def create_rand_cat(cls, cache_directory=None, patch_centers=None, **kwargs):
        """The example random catalog."""
        patch_args = (
            dict(patch_centers=patch_centers)
            if patch_centers is not None
            else cls._default_patch_args()
        )
        return cls._catalog(
            cache_directory, PATH.rand, **patch_args, **kwargs
        )

    @classmethod
    def create_unknown_cat(cls, cache_directory=None, patch_centers=None, **kwargs):
        """The example unknown-sample catalog (the data sample itself when
        the real survey files are used, matching the reference)."""
        patch_args = (
            dict(patch_centers=patch_centers)
            if patch_centers is not None
            else cls._default_patch_args()
        )
        return cls._catalog(
            cache_directory, PATH.unknown, **patch_args, **kwargs
        )

    PATCH_CENTERS_RADIAN = (
        # the 11 published 2dFLenS example patch centers (ra, dec in
        # radian; the reference embeds the same values as a hex-encoded
        # float64 blob, yaw/examples/__init__.py:120-135)
        (5.8398726664907805, -0.5308537262577498),
        (6.0089587987157955, -0.5457853928651728),
        (6.171996103859462, -0.5852504545186897),
        (6.187064081579239, -0.5005773442288902),
        (0.046040582143623526, -0.5328037657296909),
        (0.19610405428659086, -0.5215547445855805),
        (0.3419091859126378, -0.5395069571992255),
        (0.6198891140085112, -0.5416796394044717),
        (0.47805985884035945, -0.5351140149621503),
        (0.855940802991991, -0.5312453954893827),
        (0.7469560329244929, -0.5283597224907032),
    )

    DOWNLOAD_URL_TEMPLATE = (
        "https://2dflens.swin.edu.au/data_2df{}z_kidss.tar.gz"
    )

    @classmethod
    def _parse_datafile(cls, fileobj) -> dict:
        """Parse one 2dFLenS ASCII table (3 header lines, whitespace
        columns) into RA/Dec/redshift/weight arrays."""
        fileobj.readline()
        header = fileobj.readline().decode().split()[1:]
        fileobj.readline()
        array = np.loadtxt(fileobj)
        return {
            name: array[:, header.index(name)]
            for name in ("RA", "Dec", "redshift", "wei")
        }

    @classmethod
    def _patch_ids(cls, ra_deg, dec_deg):
        """Nearest published patch center on the unit sphere (the
        reference uses scipy ``vq`` over the same centers)."""
        centers = np.asarray(cls.PATCH_CENTERS_RADIAN)
        centers_xyz = radec_to_xyz(centers[:, 0], centers[:, 1])
        xyz = radec_to_xyz(np.deg2rad(ra_deg), np.deg2rad(dec_deg))
        return np.argmax(xyz @ centers_xyz.T, axis=1).astype(np.int16)

    @classmethod
    def download_and_update(cls, target=None) -> "_Path":
        """Download the 2dFLenS southern-field data and prepare the
        example survey files (reference parity:
        yaw/examples/__init__.py:146-170 — data plus
        the first 5 random realisations of both redshift samples,
        concatenated, with the 11 published patch centers assigned).

        Files land in ``target`` (default: ``YAWT_EXAMPLE_DATA_DIR`` or
        the example cache) and the example API switches to them. Raises
        a RuntimeError with a pointer at the offline alternatives when
        the download fails — the deterministic mock keeps working either
        way.
        """
        import io
        import tarfile
        import urllib.error
        import urllib.request

        import pyarrow as pa
        import pyarrow.parquet as pq

        global _EXPLICIT_TARGET
        if target is not None:
            # register the custom directory so _search_dirs finds it
            _EXPLICIT_TARGET = _Path(target)
        target = _Path(target) if target is not None else _download_target()
        target.mkdir(parents=True, exist_ok=True)

        def columns_of(chunks):
            return {
                name: np.concatenate([c[name] for c in chunks])
                for name in ("RA", "Dec", "redshift", "wei")
            }

        data_chunks, rand_chunks = [], []
        try:
            for sample in ("lo", "hi"):
                url = cls.DOWNLOAD_URL_TEMPLATE.format(sample)
                with urllib.request.urlopen(url, timeout=120) as response:
                    payload = io.BytesIO(response.read())
                with tarfile.open(fileobj=payload, mode="r:*") as tar:

                    def get(prefix):
                        member = next(
                            m for m in tar if m.name.startswith(prefix)
                        )
                        return tar.extractfile(member)

                    with get("data") as f:
                        data_chunks.append(cls._parse_datafile(f))
                    for i in range(1, 6):
                        with get(f"rand{i:03d}") as f:
                            rand_chunks.append(cls._parse_datafile(f))
        except (urllib.error.URLError, OSError, StopIteration) as err:
            raise RuntimeError(
                "downloading the 2dFLenS example data failed (offline?); "
                "the deterministic mock example remains available, or "
                "point YAWT_EXAMPLE_DATA_DIR at prepared files"
            ) from err

        for chunks, path_name in (
            (data_chunks, "2dflens_kidss_data.pqt"),
            (rand_chunks, "2dflens_kidss_rand_5x.pqt"),
        ):
            columns = columns_of(chunks)
            columns["patch"] = cls._patch_ids(columns["RA"], columns["Dec"])
            pq.write_table(
                pa.table(columns), target / path_name, compression="gzip"
            )

        _refresh_paths()
        return target

    @classmethod
    def build_products(cls, force: bool = False, *, device="cuda") -> None:
        """Compute and store the example correlation products
        (``cross.hdf``, ``auto.hdf``, ``estimate.{dat,smp,cov}``) on
        ``device`` (default ``"cuda"``, which raises without a card).

        The products committed with the package are read-only;
        recomputation is refused (set ``YAWT_EXAMPLE_IGNORE_PACKAGED=1``).
        For downloaded survey files and the mock, missing products are
        computed on demand.
        """
        products_exist = PATH.cross.exists() and PATH.auto.exists()
        if products_exist and PATH.cross.parent == _PACKAGE_PRODUCTS:
            if force:
                raise RuntimeError(
                    "the committed example products are read-only; set "
                    "YAWT_EXAMPLE_IGNORE_PACKAGED=1 (mock) or "
                    "YAWT_EXAMPLE_FORCE_MOCK=1 (survey data) to compute "
                    "fresh products into the example cache"
                )
            return
        if not force and products_exist:
            return
        try:
            PATH.cross.parent.mkdir(parents=True, exist_ok=True)
            probe = PATH.cross.parent / ".yawt_write_probe"
            probe.touch()
            probe.unlink()
        except OSError as err:
            raise RuntimeError(
                f"cannot write example products to {PATH.cross.parent} "
                "(read-only survey-file directory?); set "
                "YAWT_EXAMPLE_CACHE to a writable location or "
                "YAWT_EXAMPLE_FORCE_MOCK=1 for the offline mock"
            ) from err
        from yet_another_wizz_tpu_torch.correlation.measurements import (
            autocorrelate,
            crosscorrelate,
        )
        from yet_another_wizz_tpu_torch.redshifts import RedshiftData

        cfg = _example_configuration()
        data = cls.create_data_cat(device=device)
        rand = cls.create_rand_cat(
            patch_centers=data.get_centers(), device=device
        )
        unknown = cls.create_unknown_cat(
            patch_centers=data.get_centers(), device=device
        )

        (cross_corr,) = crosscorrelate(
            cfg, data, unknown, ref_rand=rand, device=device
        )
        cross_corr.to_file(PATH.cross)
        (auto_corr,) = autocorrelate(cfg, data, rand, device=device)
        auto_corr.to_file(PATH.auto)
        RedshiftData.from_corrfuncs(cross_corr, auto_corr).to_files(
            PATH.estimate
        )


def __getattr__(name):
    # lazily computed example products, mirroring the reference's
    # module-level attributes (examples/__init__.py:271-301: config, cross,
    # auto, estimate, normalised_counts, patched_count, patched_sum_weights)
    if name == "config":
        return _example_configuration()
    if name in ("cross", "auto"):
        from yet_another_wizz_tpu_torch.correlation import load_corrfunc

        ExampleData.build_products()
        return load_corrfunc(getattr(PATH, name))
    if name == "estimate":
        from yet_another_wizz_tpu_torch.redshifts import RedshiftData

        ExampleData.build_products()
        return RedshiftData.from_files(PATH.estimate)
    if name == "normalised_counts":
        return __getattr__("cross").dd
    if name == "patched_count":
        return __getattr__("cross").dd.counts
    if name == "patched_sum_weights":
        return __getattr__("cross").dd.sum_weights
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
