"""Inputs of the port's pipeline tests: FITS tables written by hand and the
setups that read them (no JAX import; shared by ``tests/test_torch_*.py``
and ``tests/torch_cli_worker.py``).

The mock survey comes from ``generate_mock_data`` with a seed. The unknown
sample is split into tomographic bins by quantiles of its true redshift.
Every table carries a ``PATCH`` column, cells of a 4 x 2 grid in RA and
Dec, so the JAX package and the port see the same patches; a setup may
ask for kmeans patches (``num_patches``) instead.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

SIZES = dict(num_reference=2000, num_unknown=4000, num_randoms=8000)
SEED = 21
NUM_BINS = 2
NUM_PATCHES = 8
CORRELATION = dict(
    scales=dict(rmin=100.0, rmax=1000.0, unit="kpc"),
    binning=dict(zmin=0.15, zmax=1.0, num_bins=5),
)
COLUMNS = dict(ra="RA", dec="DEC", redshift="Z", weight="W")


def write_fits(path, columns):
    """A FITS binary table written by hand: float64 columns, and int32 for
    integer arrays."""

    def card(key, value):
        if isinstance(value, str):
            return f"{key:<8}= '{value}'".ljust(80)
        if isinstance(value, bool):
            value = "T" if value else "F"
        return f"{key:<8}= {value!s:>20}".ljust(80)

    def block(cards):
        text = "".join(cards) + f"{'END':<80}"
        return (text + " " * (-len(text) % 2880)).encode("ascii")

    names = list(columns)
    integer = {
        name: np.issubdtype(np.asarray(columns[name]).dtype, np.integer)
        for name in names
    }
    data = np.zeros(
        len(columns[names[0]]),
        dtype=[(n, ">i4" if integer[n] else ">f8") for n in names],
    )
    for name in names:
        data[name] = columns[name]
    table = [
        card("XTENSION", "BINTABLE"), card("BITPIX", 8), card("NAXIS", 2),
        card("NAXIS1", data.dtype.itemsize), card("NAXIS2", len(data)),
        card("PCOUNT", 0), card("GCOUNT", 1), card("TFIELDS", len(names)),
    ]
    for i, name in enumerate(names, 1):
        table += [card(f"TTYPE{i}", name), card(f"TFORM{i}", "J" if integer[name] else "D")]
    raw = data.tobytes()
    with open(path, "wb") as f:
        f.write(block([card("SIMPLE", True), card("BITPIX", 8), card("NAXIS", 0)]))
        f.write(block(table))
        f.write(raw + b"\x00" * (-len(raw) % 2880))


def grid_patches(ra, dec):
    """Patch ids of a 4 x 2 grid over the mock's region (40-60 deg RA,
    -10-10 deg Dec, in radian)."""
    ra_cell = np.clip(((np.rad2deg(ra) - 40.0) // 5.0).astype(int), 0, 3)
    dec_cell = (np.rad2deg(dec) > 0.0).astype(int)
    return (ra_cell + 4 * dec_cell).astype(np.int32)


def write_inputs(root, *, num_bins: int = NUM_BINS, seed: int = SEED,
                 sizes: dict | None = None) -> dict:
    """Write the mock survey as FITS files under ``root``: the reference,
    the randoms and ``num_bins`` tomographic bins of the unknown sample.
    Returns their paths (``unknown`` maps bin index to path)."""
    from yet_another_wizz_tpu_torch.examples import generate_mock_data

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    mock = generate_mock_data(**(sizes or SIZES), seed=seed)

    def table(sample, select=slice(None)):
        return dict(
            RA=np.rad2deg(sample["ra"][select]),
            DEC=np.rad2deg(sample["dec"][select]),
            Z=sample["redshifts"][select],
            W=sample["weights"][select],
            PATCH=grid_patches(sample["ra"][select], sample["dec"][select]),
        )

    paths = dict(reference=root / "reference.fits", randoms=root / "randoms.fits")
    write_fits(paths["reference"], table(mock["reference"]))
    write_fits(paths["randoms"], table(mock["randoms"]))
    redshifts = mock["unknown"]["redshifts"]
    cuts = np.quantile(redshifts, np.linspace(0.0, 1.0, num_bins + 1))
    cuts[0], cuts[-1] = -np.inf, np.inf
    paths["unknown"] = {}
    for index in range(1, num_bins + 1):
        select = (redshifts > cuts[index - 1]) & (redshifts <= cuts[index])
        paths["unknown"][index] = root / f"unknown_{index}.fits"
        write_fits(paths["unknown"][index], table(mock["unknown"], select))
    return {
        key: {k: str(v) for k, v in value.items()} if isinstance(value, dict)
        else str(value)
        for key, value in paths.items()
    }


def base_setup(paths: dict, tasks: list, *, patches: bool = True,
               execution: dict | None = None) -> dict:
    """A setup of the JAX package's schema over :func:`write_inputs`'s
    files: the ``PATCH`` column, or kmeans with ``patches=False``."""
    patch_key = dict(patches="PATCH") if patches else {}
    setup = dict(
        correlation={key: dict(value) for key, value in CORRELATION.items()},
        inputs=dict(
            reference=dict(
                path_data=paths["reference"], path_rand=paths["randoms"],
                **COLUMNS, **patch_key,
            ),
            unknown=dict(
                path_data=dict(paths["unknown"]),
                path_rand={index: paths["randoms"] for index in paths["unknown"]},
                **COLUMNS, **patch_key,
            ),
        ),
        tasks=list(tasks),
    )
    if not patches:
        setup["inputs"]["num_patches"] = NUM_PATCHES
    if execution:
        setup["execution"] = dict(execution)
    return setup


def write_setup(path, setup: dict) -> str:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(setup, f)
    return str(path)


def product_files(project) -> list[str]:
    """Relative paths of a project's products: pair counts, estimates, true
    histograms and plots (not the caches, the log or the lock)."""
    project = Path(project)
    return sorted(
        str(path.relative_to(project))
        for sub in ("paircounts", "estimate", "true", "plots")
        for path in (project / sub).rglob("*") if path.is_file()
    )
