"""Inputs of the chunk-skip counters' tests at the reach of the DES Y3
source-bin calibration (benchmark configuration ``des_y3_redmagic``): one
scale, 1.5-5 Mpc unweighted, 37 bins over (0.15, 0.89], reference and
unknown samples at the configuration's densities (630 and 6,046 per deg2)
over a small field. Imports no JAX: the card's tests share it."""

from __future__ import annotations

import numpy as np

from yet_another_wizz_tpu_torch.catalog import Catalog
from yet_another_wizz_tpu_torch.config import Configuration
from yet_another_wizz_tpu_torch.correlation.measurements import PatchLinkage

CONFIG = dict(rmin=1.5, rmax=5.0, unit="Mpc", zmin=0.15, zmax=0.89, num_bins=37)
DENSITY = dict(reference=630.0, unknown=6046.0)
"""Objects per deg2 of the configuration's samples."""


def field_catalog(rng, name: str, region, *, device, **patches) -> Catalog:
    """Uniform points at the sample's density over the RA/Dec ``region``
    (degrees), redshifts uniform over the binning, weights in [0.5, 2]."""
    ra0, ra1, dec0, dec1 = np.deg2rad(region)
    area = (ra1 - ra0) * (np.sin(dec1) - np.sin(dec0)) * (180 / np.pi) ** 2
    n = int(DENSITY[name] * area)
    return Catalog.from_arrays(
        ra=rng.uniform(ra0, ra1, n),
        dec=np.arcsin(rng.uniform(np.sin(dec0), np.sin(dec1), n)),
        redshifts=rng.uniform(0.15, 0.9, n),
        weights=rng.uniform(0.5, 2.0, n),
        degrees=False, device=device, **patches,
    )


def count_inputs(kind: str, *, seed: int = 20, device="cpu",
                 region=(10.0, 13.0, -1.5, 1.5), num_patches: int = 4):
    """``(tiles1, tiles2, pairs, table, cols_binned)`` of one cumulative
    count as the measurement builds it: the cross count ``"cross"``
    (reference rows, unknown columns) or the binned autocorrelation count
    ``"auto"`` of the reference."""
    rng = np.random.default_rng(seed)
    reference = field_catalog(rng, "reference", region, device=device,
                              patch_num=num_patches)
    config = Configuration.create(**CONFIG)
    if kind == "cross":
        unknown = field_catalog(rng, "unknown", region, device=device,
                                patch_centers=reference)
        links = PatchLinkage.from_catalogs(config, reference, unknown)
        tiles1, tiles2, pairs = links._build_engine_inputs(reference, unknown)
    else:
        links = PatchLinkage.from_catalogs(config, reference)
        tiles1, tiles2, pairs = links._build_engine_inputs(
            reference, reference, auto=True, binned2=True
        )
    table, _, direct, _ = links.engine_table()
    assert direct is None
    return tiles1, tiles2, pairs, table, kind == "auto"
