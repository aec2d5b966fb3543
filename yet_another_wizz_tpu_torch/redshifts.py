"""Redshift distribution estimates: histograms and clustering redshifts.

Capability parity with the reference ``yaw.redshifts``
(yaw/redshifts.py:44-404), ported from the JAX package's ``redshifts.py``:
:class:`HistData` (per-patch weighted redshift histograms with jackknife or
bootstrap samples, numpy only) and :class:`RedshiftData` (the clustering
redshift estimate
``n(z) = w_sp / sqrt(dz^2 w_ss w_pp)`` from cross-/autocorrelation
functions, with normalisation by integration or by fitting to a target).

The reference fits the relative normalisation with MINPACK
(``scipy.optimize.curve_fit``); the one-parameter weighted least squares
has a closed form which is used here instead.
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.binning import Binning
from yet_another_wizz_tpu_torch.correlation.corrdata import CorrData
from yet_another_wizz_tpu_torch.correlation.paircounts import (
    BOOTSTRAP_SEED,
    DEFAULT_NUM_BOOTSTRAP,
    bootstrap_multiplicities,
)
from yet_another_wizz_tpu_torch.options import ResamplingMethod

if TYPE_CHECKING:
    from numpy.typing import NDArray
    from typing_extensions import Self

    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.config import BinningConfig, Configuration
    from yet_another_wizz_tpu_torch.correlation.corrfunc import CorrFunc

__all__ = [
    "HistData",
    "RedshiftData",
]

logger = logging.getLogger(__name__)


def _histogram_rows(
    redshifts, weights, patch_ids, num_patches, binning: Binning
) -> NDArray:
    """Per-patch weighted histogram of one batch of rows, shape (P, B).

    Unlike ``np.histogram`` (which closes both outer edges), the digitize
    path drops values on the open outer edge by itself: with
    ``closed=right`` a value equal to ``edges[0]`` digitizes below the
    first bin, with ``closed=left`` a value equal to ``edges[-1]``
    digitizes past the last; both fail the ``valid`` check. Weights enter
    as they are (no row is taken for padding by its weight).
    """
    num_bins = len(binning)
    bin_idx = binning.digitize(redshifts) - 1
    valid = (bin_idx >= 0) & (bin_idx < num_bins)
    flat = patch_ids[valid].astype(np.int64) * num_bins + bin_idx[valid]
    histogram = np.bincount(
        flat,
        weights=weights[valid] if weights is not None else None,
        minlength=num_patches * num_bins,
    )
    return histogram.reshape(num_patches, num_bins).astype(np.float64)


def _patch_histograms(
    catalog: Catalog,
    binning: Binning,
    max_resident_patches: int | None = None,
) -> NDArray:
    """Weighted redshift histogram per patch, shape (P, B), from the
    catalog's own rows.

    Out-of-core catalogs (:class:`~yet_another_wizz_tpu_torch.catalog.lazy.
    LazyCatalog`) that expose ``load_block`` but no memory-resident
    columns are histogrammed block by block with host memory bounded at
    ``max_resident_patches`` patches (the same knob as the blocked
    measurement path)."""
    num_patches = catalog.num_patches
    if not hasattr(catalog, "redshifts"):
        if not catalog.has_redshifts:
            raise ValueError("catalog has no 'redshifts' attached")
        block = max(1, int(max_resident_patches or 16))
        counts = np.zeros((num_patches, len(binning)))
        for lo in range(0, num_patches, block):
            hi = min(lo + block, num_patches)
            data = catalog.load_block(lo, hi)
            counts += _histogram_rows(
                data.redshifts, data.weights,
                data.patch_ids + lo, num_patches, binning,
            )
        return counts

    redshifts = catalog.redshifts
    if redshifts is None:
        raise ValueError("catalog has no 'redshifts' attached")
    return _histogram_rows(
        redshifts, catalog.weights, catalog.patch_ids, num_patches, binning
    )


def resample_jackknife(observations: NDArray, patch_rows: bool = True) -> NDArray:
    """Leave-one-out sums over the patch axis of per-patch observations
    with shape (P, B)."""
    if not patch_rows:
        observations = observations.T
    totals = observations.sum(axis=0)
    return totals[None, :] - observations


def resample_bootstrap(
    observations: NDArray,
    num_samples: int = DEFAULT_NUM_BOOTSTRAP,
    seed: int = BOOTSTRAP_SEED,
) -> NDArray:
    """Bootstrap sums over the patch axis of per-patch observations."""
    mult = bootstrap_multiplicities(len(observations), num_samples, seed)
    return mult @ observations


class HistData(CorrData):
    """A redshift histogram with patch-resampled samples and covariance."""

    __slots__ = ()  # storage slots live on SampledData

    @classmethod
    def from_catalog(
        cls: type[Self],
        catalog: Catalog,
        config: Configuration | BinningConfig,
        *,
        method: ResamplingMethod | str = ResamplingMethod.jackknife,
        progress: bool = False,
        max_workers: int | None = None,
        max_resident_patches: int | None = None,
    ) -> Self:
        """Histogram the catalog redshifts in the configured bins, with
        jackknife (default) or bootstrap samples over the patches.

        ``max_resident_patches`` bounds the host memory of out-of-core
        (lazy) catalogs at that many resident patches. ``progress`` and
        ``max_workers`` are accepted for interface compatibility; the
        histogram runs in this process."""
        logger.info("computing redshift histogram")
        binning_config = getattr(config, "binning", config)
        binning = getattr(binning_config, "binning", binning_config)
        if not isinstance(binning, Binning):
            raise TypeError("'config' must provide a redshift binning")

        method = ResamplingMethod(method)
        counts = _patch_histograms(
            catalog, binning, max_resident_patches=max_resident_patches
        )
        if method == ResamplingMethod.jackknife:
            samples = resample_jackknife(counts)
        else:
            samples = resample_bootstrap(counts)
        return cls(binning.copy(), counts.sum(axis=0), samples, method=method)

    @property
    def _description_data(self) -> str:
        return "n(z) histogram with symmetric 68% percentile confidence"

    @property
    def _description_samples(self) -> str:
        return f"{self.num_samples} n(z) histogram {self.method} samples"

    @property
    def _description_covariance(self) -> str:
        n = self.num_bins
        return f"n(z) histogram covariance matrix ({n}x{n})"

    def normalised(self, *args, **kwargs) -> Self:
        """Rescale the histogram to a probability density (any arguments
        are accepted and ignored, for interface compatibility)."""
        logger.debug("normalising %s", type(self).__name__)

        edges = self.binning.edges
        dz = self.binning.dz
        width_correction = (edges.min() - edges.max()) / (self.num_bins * dz)
        data = self.data * width_correction
        samples = self.samples * width_correction
        norm = np.nansum(dz * data)
        return type(self)(
            self.binning, data / norm, samples / norm, method=self.method
        )


class RedshiftData(CorrData):
    """The clustering redshift estimate n(z) with samples and covariance."""

    __slots__ = ()  # storage slots live on SampledData

    @classmethod
    def from_corrdata(
        cls: type[Self],
        cross_data: CorrData,
        ref_data: CorrData | None = None,
        unk_data: CorrData | None = None,
    ) -> Self:
        """Combine sampled correlation functions into the redshift estimate

        .. math::
            n(z) = w_{sp} / \\sqrt{\\Delta z^2 \\, w_{ss} \\, w_{pp}}

        where the autocorrelation terms are optional sample-bias
        corrections.
        """
        logger.debug(
            "computing clustering redshifts from correlation function samples"
        )
        mitigate = []

        if ref_data is None:
            w_ss_data = w_ss_samples = 1.0
        else:
            ref_data.is_compatible(cross_data, require=True)
            w_ss_data, w_ss_samples = ref_data.data, ref_data.samples
            mitigate.append("reference")

        if unk_data is None:
            w_pp_data = w_pp_samples = 1.0
        else:
            unk_data.is_compatible(cross_data, require=True)
            w_pp_data, w_pp_samples = unk_data.data, unk_data.samples
            mitigate.append("unknown")

        logger.debug(
            "mitigating %s sample bias", " and ".join(mitigate) or "no"
        )

        dz2 = cross_data.binning.dz**2
        nz_data = cross_data.data / np.sqrt(dz2 * w_ss_data * w_pp_data)
        nz_samples = cross_data.samples / np.sqrt(
            dz2[None, :] * w_ss_samples * w_pp_samples
        )
        return cls(
            cross_data.binning, nz_data, nz_samples, method=cross_data.method
        )

    @classmethod
    def from_corrfuncs(
        cls: type[Self],
        cross_corr: CorrFunc,
        ref_corr: CorrFunc | None = None,
        unk_corr: CorrFunc | None = None,
        *,
        method: ResamplingMethod | str = ResamplingMethod.jackknife,
        num_samples: int | None = None,
    ) -> Self:
        """Sample the input pair counts and combine them with
        :meth:`from_corrdata`."""
        for corr in (ref_corr, unk_corr):
            if corr is not None:
                cross_corr.is_compatible(corr, require=True)

        cross_data = cross_corr.sample(method, num_samples)
        ref_data = ref_corr.sample(method, num_samples) if ref_corr else None
        unk_data = unk_corr.sample(method, num_samples) if unk_corr else None
        return cls.from_corrdata(cross_data, ref_data, unk_data)

    @property
    def _description_data(self) -> str:
        return "n(z) estimate with symmetric 68% percentile confidence"

    @property
    def _description_samples(self) -> str:
        return f"{self.num_samples} n(z) {self.method} samples"

    @property
    def _description_covariance(self) -> str:
        n = self.num_bins
        return f"n(z) estimate covariance matrix ({n}x{n})"

    def normalised(self, target: CorrData | None = None) -> Self:
        """Normalise to unit integral, or fit a relative normalisation to a
        target distribution (one-parameter weighted least squares in closed
        form; both are approximate for noisy, partially negative data)."""
        if target is None:
            logger.debug("normalising %s", type(self).__name__)
            norm = np.nansum(self.binning.dz * self.data)
        else:
            logger.debug(
                "normalising %s to target distribution", type(self).__name__
            )
            y_from = self.data
            y_target = target.data
            mask = (
                np.isfinite(y_from) & np.isfinite(y_target) & (y_target > 0.0)
            )
            # fit y_target ~ y_from / norm with sigma = 1 / y_target:
            # chi2(n) = sum w (y_t - y_f / n)^2, w = y_t^2 -> closed form
            w = y_target[mask] ** 2
            numerator = np.sum(w * y_from[mask] ** 2)
            denominator = np.sum(w * y_from[mask] * y_target[mask])
            norm = numerator / denominator

        return type(self)(
            self.binning,
            self.data / norm,
            self.samples / norm,
            method=self.method,
        )
