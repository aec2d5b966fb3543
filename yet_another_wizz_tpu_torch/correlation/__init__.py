"""Correlation measurement layer: pair-count containers, estimators and
sampled correlation data."""

from yet_another_wizz_tpu_torch.correlation.corrdata import CorrData, SampledData
from yet_another_wizz_tpu_torch.correlation.corrfunc import (
    CorrFunc,
    ScalarCorrFunc,
    load_corrfunc,
)
from yet_another_wizz_tpu_torch.correlation.measurements import crosscorrelate
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
    "crosscorrelate",
    "load_corrfunc",
]
