"""Correlation-function containers built from normalised pair counts.

Capability parity with the reference ``yaw.correlation.corrfunc``
(yaw/correlation/corrfunc.py:69-427): the
Davis-Peebles / Landy-Szalay / scalar estimators, :class:`CorrFunc`
(dd/dr/rd/rr pair counts, estimator auto-selection, jackknife sampling into
:class:`~yet_another_wizz_tpu_torch.correlation.corrdata.CorrData`),
:class:`ScalarCorrFunc`, HDF5 round trips with the v2 legacy group names,
and the type-dispatching :func:`load_corrfunc` loader.

Extension: :meth:`BaseCorrFunc.sample` accepts jackknife (default) or
bootstrap patch resampling.
"""

from __future__ import annotations

import logging
from abc import abstractmethod
from typing import TYPE_CHECKING, Generic, TypeVar


from yet_another_wizz_tpu_torch.correlation.corrdata import CorrData
from yet_another_wizz_tpu_torch.correlation.paircounts import (
    BaseNormalisedCounts,
    NormalisedCounts,
    NormalisedScalarCounts,
)
from yet_another_wizz_tpu_torch.options import ResamplingMethod
from yet_another_wizz_tpu_torch.utils import write_version_tag
from yet_another_wizz_tpu_torch.utils.abc import (
    BinwiseData,
    HdfSerializable,
    PatchwiseData,
    Serialisable,
)

if TYPE_CHECKING:
    from collections.abc import Callable
    from pathlib import Path
    from typing import Any

    from h5py import Group
    from numpy.typing import NDArray
    from typing_extensions import Self

    from yet_another_wizz_tpu_torch.binning import Binning
    from yet_another_wizz_tpu_torch.utils.abc import TypeSliceIndex

T = TypeVar("T", bound=BaseNormalisedCounts)

__all__ = [
    "CorrFunc",
    "EstimatorError",
    "ScalarCorrFunc",
    "davis_peebles",
    "landy_szalay",
    "load_corrfunc",
    "scalar_correlation",
]

logger = logging.getLogger(__name__)


# estimator models live in the models subpackage; re-exported here for
# API parity with the reference module layout
from yet_another_wizz_tpu_torch.models.estimators import (  # noqa: E402
    EstimatorError,
    davis_peebles,
    landy_szalay,
    scalar_correlation,
)


class BaseCorrFunc(
    Generic[T],
    BinwiseData,
    PatchwiseData,
    Serialisable,
    HdfSerializable,
):
    """Common behaviour of pair-count based correlation containers.

    Stores a mapping of pair-count kinds (``dd`` mandatory, plus optional
    randoms terms) and evaluates the appropriate estimator on patch-summed
    totals and resampled realisations.
    """

    __slots__ = ("_counts",)

    _counts: dict[str, T]
    _counts_type: type[T]
    _hdf_names: dict[str, str]

    def _init(self, dd: T, **optional: T | None) -> None:
        if type(dd) is not self._counts_type:
            raise TypeError(f"pair counts must be of type {self._counts_type}")
        if not optional:
            # reference-identical: concrete __init__s always pass their
            # keyword Nones, so a dd-only instance constructs fine (as in
            # yaw/correlation/corrfunc.py:122-126) and
            # the missing-counts error surfaces at estimator time
            raise EstimatorError("missing at least one additional pair count")

        self._counts = dict(dd=dd)
        for kind, counts in optional.items():
            if counts is None:
                continue
            try:
                dd.is_compatible(counts, require=True)
            except ValueError as err:
                raise ValueError(
                    f"pair counts '{kind}' and 'dd' are not compatible"
                ) from err
            self._counts[kind] = counts

    def __repr__(self) -> str:
        kinds = "|".join(self._counts)
        return (
            f"{type(self).__name__}(counts={kinds}, auto={self.auto}, "
            f"binning={self.binning}, num_patches={self.num_patches})"
        )

    @property
    def binning(self) -> Binning:
        return self.dd.binning

    @property
    def auto(self) -> bool:
        """Whether the pair counts describe an autocorrelation function."""
        return self.dd.auto

    @property
    def dd(self) -> T:
        """The data-data pair counts."""
        return self._counts["dd"]

    @property
    def num_patches(self) -> int:
        return self.dd.num_patches

    @classmethod
    def from_hdf(cls: type[Self], source: Group) -> Self:
        try:
            kind = source["kind"][()].decode("utf-8")
        except KeyError:
            kind = "CorrFunc"
        if kind != cls.__name__:
            raise TypeError(f"input file stores pair counts for type '{kind}'")

        kwargs = {}
        for key, group_name in cls._hdf_names.items():
            if group_name in source:
                kwargs[key] = cls._counts_type.from_hdf(source[group_name])
            else:
                kwargs[key] = None
        return cls.from_dict(kwargs)

    def to_hdf(self, dest: Group) -> None:
        write_version_tag(dest)
        dest.create_dataset("kind", data=type(self).__name__)
        for key, counts in self._counts.items():
            counts.to_hdf(dest.create_group(self._hdf_names[key]))

    @classmethod
    def from_file(cls: type[Self], path: Path | str) -> Self:
        logger.info("reading %s from: %s", cls.__name__, path)
        return super().from_file(path)

    def to_file(self, path: Path | str) -> None:
        logger.info("writing %s to: %s", type(self).__name__, path)
        super().to_file(path)

    def to_dict(self) -> dict[str, Any]:
        return self._counts.copy()

    def __eq__(self, other: Any) -> bool:
        if type(self) is not type(other):
            return NotImplemented
        keys = set(self._counts) | set(other._counts)
        return all(
            self._counts.get(key) == other._counts.get(key) for key in keys
        )

    __hash__ = None

    def __add__(self, other: Any) -> Self:
        if type(self) is not type(other):
            return NotImplemented
        self.is_compatible(other, require=True)
        if set(self._counts) != set(other._counts):
            raise ValueError("pair counts of operands do not match")
        kwargs = {
            key: counts + other._counts[key]
            for key, counts in self._counts.items()
        }
        return type(self).from_dict(kwargs)

    def __mul__(self, factor: float) -> Self:
        kwargs = {
            key: counts * factor for key, counts in self._counts.items()
        }
        return type(self).from_dict(kwargs)

    def _make_bin_slice(self, item: TypeSliceIndex) -> Self:
        kwargs = {key: counts.bins[item] for key, counts in self._counts.items()}
        return type(self).from_dict(kwargs)

    def _make_patch_slice(self, item: TypeSliceIndex) -> Self:
        kwargs = {
            key: counts.patches[item] for key, counts in self._counts.items()
        }
        return type(self).from_dict(kwargs)

    def is_compatible(self, other: Any, *, require: bool = False) -> bool:
        if type(self) is not type(other):
            if not require:
                return False
            raise TypeError(f"{type(other)} is not compatible with {type(self)}")
        return self.dd.is_compatible(other.dd, require=require)

    @abstractmethod
    def get_estimator(self) -> Callable[..., NDArray]:
        """The most appropriate estimator for the stored pair counts."""

    def sample(
        self,
        method: ResamplingMethod | str = ResamplingMethod.jackknife,
        num_samples: int | None = None,
        estimator: str | None = None,
    ) -> CorrData:
        """Estimate the correlation function per redshift bin.

        Sums pair counts over patches, applies the estimator (Landy-Szalay
        when RR counts exist, otherwise Davis-Peebles) to the totals and to
        every patch-resampled realisation.

        Args:
            method: ``jackknife`` (default) or ``bootstrap``.
            num_samples: number of bootstrap realisations (bootstrap only).
            estimator: optional estimator override by registered name
                (``DP``, ``LS``, ...); by default the most appropriate
                estimator for the stored counts is chosen.
        """
        from inspect import Parameter, signature

        from yet_another_wizz_tpu_torch.models.estimators import get_estimator

        if estimator is None:
            estimator_fn = self.get_estimator()
        else:
            estimator_fn = get_estimator(estimator)
        logger.debug(
            "sampling correlation function with estimator '%s'",
            estimator_fn.name,
        )

        params = signature(estimator_fn).parameters
        required = {
            name
            for name, param in params.items()
            if param.default is Parameter.empty
        }
        missing = required - {
            key for key, counts in self._counts.items() if counts is not None
        }
        if missing:
            raise EstimatorError(
                f"estimator '{estimator_fn.name}' requires pair counts "
                f"not measured here: {', '.join(sorted(missing)).upper()}"
            )

        totals = {}
        samples = {}
        for key, counts in self._counts.items():
            if key not in params:
                continue  # e.g. forced DP ignores measured RR
            sampled = counts.sample_patch_sum(method, num_samples)
            totals[key] = sampled.data
            samples[key] = sampled.samples

        return CorrData(
            self.binning,
            estimator_fn(**totals),
            estimator_fn(**samples),
            method=method,
        )


class CorrFunc(BaseCorrFunc[NormalisedCounts]):
    """Pair counts of a correlation measurement (DD plus at least one of
    DR/RD/RR), with estimator evaluation and patch resampling.

    Typically produced by :func:`~yet_another_wizz_tpu_torch.crosscorrelate` or
    :func:`~yet_another_wizz_tpu_torch.autocorrelate`, one instance per scale.
    """

    __slots__ = ()  # the storage slot lives on BaseCorrFunc

    _counts_type = NormalisedCounts
    _hdf_names = dict(
        dd="data_data",
        dr="data_random",
        rd="random_data",
        rr="random_random",
    )

    def __init__(
        self,
        dd: NormalisedCounts,
        dr: NormalisedCounts | None = None,
        rd: NormalisedCounts | None = None,
        rr: NormalisedCounts | None = None,
    ) -> None:
        self._init(dd=dd, dr=dr, rd=rd, rr=rr)

    def get_estimator(self) -> Callable[..., NDArray]:
        return davis_peebles if self.rr is None else landy_szalay

    @property
    def dr(self) -> NormalisedCounts | None:
        """The data-random pair counts."""
        return self._counts.get("dr")

    @property
    def rd(self) -> NormalisedCounts | None:
        """The random-data pair counts."""
        return self._counts.get("rd")

    @property
    def rr(self) -> NormalisedCounts | None:
        """The random-random pair counts."""
        return self._counts.get("rr")


class ScalarCorrFunc(CorrFunc):
    """Pair counts of a scalar-field (kappa) correlation measurement."""

    __slots__ = ()  # the storage slot lives on BaseCorrFunc

    _counts_type = NormalisedScalarCounts
    _hdf_names = dict(dd="data_data", dr="data_random")

    def __init__(
        self,
        dd: NormalisedScalarCounts,
        dr: NormalisedScalarCounts | None = None,
    ) -> None:
        self._init(dd=dd, dr=dr)

    def get_estimator(self) -> Callable[..., NDArray]:
        return scalar_correlation


def load_corrfunc(path: Path | str) -> BaseCorrFunc:
    """Load correlation pair counts from HDF5, dispatching on the stored
    container type (``CorrFunc`` or ``ScalarCorrFunc``)."""
    import h5py

    with h5py.File(str(path), mode="r") as f:
        for cls in (ScalarCorrFunc, CorrFunc):
            try:
                return cls.from_hdf(f)
            except TypeError as err:
                if "stores pair counts" not in str(err):
                    raise
    raise ValueError(
        "input file is not compatible with any correlation data "
        f"implementation: {path}"
    )
