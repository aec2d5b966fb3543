"""Clustering redshift estimates.

Capability parity with the reference ``yaw.redshifts``
(yaw/redshifts.py:44-404) for :class:`RedshiftData` (the clustering
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
from yet_another_wizz_tpu_torch.options import ResamplingMethod

if TYPE_CHECKING:
    from numpy.typing import NDArray
    from typing_extensions import Self

    from yet_another_wizz_tpu_torch.correlation.corrfunc import CorrFunc

__all__ = [
    "RedshiftData",
]

logger = logging.getLogger(__name__)


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
