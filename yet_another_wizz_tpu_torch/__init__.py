"""yet_another_wizz_tpu_torch: clustering-redshift estimation in PyTorch.

The PyTorch + CUDA counterpart of ``yet_another_wizz_tpu``. It runs the
cross- and autocorrelation measurements (``crosscorrelate``,
``autocorrelate`` with Landy-Szalay, their scalar-field variants
``crosscorrelate_scalar`` / ``autocorrelate_scalar``, optionally with
separation weighting, optionally with the exact-boundary ``audit``),
jackknife or bootstrap n(z) recovery (``RedshiftData.from_corrfuncs``) and
redshift histograms (``HistData``) with the same host pipeline as the JAX
package: patch-resolved catalogs, Morton-sorted
point tiles, a cap-pruned tile-pair list, and the float64 estimators. The
pair-count engine is a hand-written CUDA kernel
(:mod:`yet_another_wizz_tpu_torch.ops.cuda_paircount`) for tensors on a
CUDA device, with a plain PyTorch engine for tensors on the CPU. Large
catalogs are ingested into disk caches (``Catalog.from_file``,
``Catalog.from_random`` with ``BoxRandoms`` / ``HealPixRandoms``), reopened
in memory (``Catalog(cache)``) or lazily (``LazyCatalog``), and measured
block by block with ``max_resident_patches``.

This package imports neither ``jax`` nor ``yet_another_wizz_tpu``.
"""

from yet_another_wizz_tpu_torch._version import __version__, __version_tuple__
from yet_another_wizz_tpu_torch.binning import Binning
from yet_another_wizz_tpu_torch.coordinates import (
    AngularCoordinates,
    AngularDistances,
)
from yet_another_wizz_tpu_torch.cosmology import (
    CustomCosmology,
    FLRWCosmology,
    Planck15,
    cosmology_is_equal,
    get_default_cosmology,
    new_scales,
)

__all__ = [
    "AngularCoordinates",
    "AngularDistances",
    "Binning",
    "BoxRandoms",
    "Catalog",
    "Configuration",
    "CorrData",
    "CorrFunc",
    "CustomCosmology",
    "FLRWCosmology",
    "HealPixRandoms",
    "HistData",
    "LazyCatalog",
    "Planck15",
    "RedshiftData",
    "ScalarCorrFunc",
    "__version__",
    "__version_tuple__",
    "autocorrelate",
    "autocorrelate_scalar",
    "cosmology_is_equal",
    "crosscorrelate",
    "crosscorrelate_scalar",
    "get_default_cosmology",
    "load_corrfunc",
    "new_scales",
]


def __getattr__(name):
    # late imports keep config-only use free of torch
    if name in ("Catalog", "LazyCatalog"):
        from yet_another_wizz_tpu_torch import catalog

        return getattr(catalog, name)
    if name in ("BoxRandoms", "HealPixRandoms"):
        from yet_another_wizz_tpu_torch import randoms

        return getattr(randoms, name)
    if name == "Configuration":
        from yet_another_wizz_tpu_torch.config import Configuration

        return Configuration
    if name in ("CorrData", "CorrFunc", "ScalarCorrFunc", "load_corrfunc"):
        from yet_another_wizz_tpu_torch import correlation

        return getattr(correlation, name)
    if name in (
        "autocorrelate", "autocorrelate_scalar", "crosscorrelate",
        "crosscorrelate_scalar",
    ):
        from yet_another_wizz_tpu_torch.correlation import measurements

        return getattr(measurements, name)
    if name in ("HistData", "RedshiftData"):
        from yet_another_wizz_tpu_torch import redshifts

        return getattr(redshifts, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
