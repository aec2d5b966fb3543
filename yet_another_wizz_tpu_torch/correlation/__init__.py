"""Correlation measurement layer: pair-count containers, estimators and
sampled correlation data."""

from yet_another_wizz_tpu_torch.correlation.corrdata import CorrData, SampledData
from yet_another_wizz_tpu_torch.correlation.corrfunc import (
    CorrFunc,
    ScalarCorrFunc,
    load_corrfunc,
)
from yet_another_wizz_tpu_torch.correlation.measurements import (
    autocorrelate,
    autocorrelate_scalar,
    crosscorrelate,
    crosscorrelate_scalar,
)
from yet_another_wizz_tpu_torch.correlation.paircounts import (
    NormalisedCounts,
    NormalisedScalarCounts,
    PatchedCounts,
    PatchedSumWeights,
)

__all__ = [
    "CorrData",
    "CorrFunc",
    "NormalisedCounts",
    "NormalisedScalarCounts",
    "PatchedCounts",
    "PatchedSumWeights",
    "SampledData",
    "ScalarCorrFunc",
    "autocorrelate",
    "autocorrelate_scalar",
    "crosscorrelate",
    "crosscorrelate_scalar",
    "load_corrfunc",
]
