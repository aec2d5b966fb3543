"""Binned measurements with spatial-resampling samples and covariance.

Capability parity with the reference ``yaw.correlation.corrdata``
(yaw/correlation/corrdata.py:48-608): the
:class:`SampledData` container (data per redshift bin + patch-resampled
samples), covariance estimation (full/diag/var), and the three-file ASCII
round trip of :class:`CorrData` (``.dat``/``.smp``/``.cov``) in the
reference's exact file format.

Extension over the reference: samples may originate from jackknife *or*
bootstrap resampling; the covariance normalisation adapts accordingly
(jackknife: ``(M - 1) * cov``; bootstrap: unbiased sample covariance of
the replicates, ``ddof=1``).
"""

from __future__ import annotations

import logging
import warnings
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.binning import Binning
from yet_another_wizz_tpu_torch.options import CovKind, ResamplingMethod
from yet_another_wizz_tpu_torch.utils import format_float_fixed_width
from yet_another_wizz_tpu_torch.utils.abc import AsciiSerializable, BinwiseData

if TYPE_CHECKING:
    from typing import Any

    from numpy.typing import ArrayLike, NDArray
    from typing_extensions import Self

    from yet_another_wizz_tpu_torch.utils.abc import TypeSliceIndex

__all__ = [
    "CorrData",
    "SampledData",
    "cov_from_samples",
]

PRECISION = 10
"""Column width / float precision in ASCII files."""

logger = logging.getLogger(__name__)


def cov_from_samples(
    samples: NDArray | list[NDArray],
    rowvar: bool = False,
    kind: CovKind | str = CovKind.full,
    method: ResamplingMethod | str = ResamplingMethod.jackknife,
) -> NDArray:
    """Covariance matrix estimated from patch-resampled data vectors.

    Args:
        samples:
            One set (2-dim array) or multiple sets of samples; multiple sets
            are concatenated along the observable axis to produce a joint
            covariance.
        rowvar:
            Whether observables are rows rather than columns.
        kind:
            ``full``, ``diag`` (keep only diagonals of each block) or
            ``var`` (main diagonal only).
        method:
            Jackknife samples scale the covariance by ``M - 1``; bootstrap
            uses the unbiased sample covariance of the replicates
            (``ddof=1``, i.e. plain covariance times ``M / (M - 1)``).
    """
    kind = CovKind(kind)
    method = ResamplingMethod(method)

    ax_obs = 0 if rowvar else 1
    if isinstance(samples, (list, tuple)):
        sets = [np.asarray(s) for s in samples]
        concat = np.concatenate(sets, axis=ax_obs)
    else:
        sets = [np.asarray(samples)]
        concat = sets[0]

    num_samples = concat.shape[1 if rowvar else 0]
    num_obs = concat.shape[ax_obs]
    if num_samples == 1:
        return np.full((num_obs, num_obs), np.nan)

    covmat = np.cov(concat, rowvar=rowvar, ddof=0)
    if method == ResamplingMethod.jackknife:
        covmat = covmat * (num_samples - 1)
    else:
        covmat = covmat * num_samples / (num_samples - 1)
    covmat = np.atleast_2d(covmat)

    if kind == CovKind.var:
        covmat = np.diag(np.diag(covmat))
    elif kind == CovKind.diag:
        # keep the main diagonal plus the diagonals at every cumulative
        # set-size offset — reference-identical semantics
        # (yaw/correlation/corrdata.py:88-101),
        # including its quirks for sets of UNEQUAL size (off-diagonals
        # within a larger set at a matching offset survive, cross-set
        # diagonals at non-prefix-sum offsets are dropped)
        keep = np.zeros_like(covmat, dtype=bool)
        np.fill_diagonal(keep, True)
        offset = 0
        block_sizes = [s.shape[ax_obs] for s in sets]
        for size in block_sizes[:-1]:
            offset += size
            idx = np.arange(covmat.shape[0] - offset)
            keep[idx + offset, idx] = True
            keep[idx, idx + offset] = True
        covmat = np.where(keep, covmat, 0.0)

    return covmat


class SampledData(BinwiseData):
    """Data in redshift bins plus spatial-resampling samples.

    Args:
        binning: the redshift :class:`~yet_another_wizz_tpu_torch.Binning`.
        data: values per bin, shape ``(N,)``.
        samples: resampled values, shape ``(M, N)``.
        method: resampling method that produced the samples (default
            jackknife, matching the reference).
    """

    __slots__ = ("binning", "data", "samples", "method")

    binning: Binning
    data: NDArray
    samples: NDArray
    method: ResamplingMethod

    def __init__(
        self,
        binning: Binning,
        data: ArrayLike,
        samples: ArrayLike,
        *,
        method: ResamplingMethod | str = ResamplingMethod.jackknife,
    ) -> None:
        self.binning = binning
        self.method = ResamplingMethod(method)

        self.data = np.asarray(data)
        if self.data.shape != (self.num_bins,):
            raise ValueError("unexpected shape of 'data' array")

        self.samples = np.asarray(samples)
        if self.samples.ndim != 2:
            raise ValueError("'samples' must be two-dimensional")
        if self.samples.shape[1] != self.num_bins:
            raise ValueError("number of bins for 'data' and 'samples' do not match")

    @property
    def error(self) -> NDArray:
        """Standard error per bin from the sample covariance."""
        return np.sqrt(np.diag(self.covariance))

    @property
    def covariance(self) -> NDArray:
        """Covariance matrix ``(N, N)`` estimated from the samples."""
        return cov_from_samples(self.samples, method=self.method)

    @property
    def correlation(self) -> NDArray:
        """Correlation matrix derived from :attr:`covariance`."""
        covar = self.covariance
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            stdev = np.sqrt(np.diag(covar))
            corr = covar / np.outer(stdev, stdev)
        corr[covar == 0] = 0.0
        return corr

    @property
    def num_samples(self) -> int:
        """Number of resampling samples."""
        return len(self.samples)

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(binning={self.binning}, "
            f"num_samples={self.num_samples})"
        )

    def __getstate__(self) -> dict:
        return dict(
            binning=self.binning,
            data=self.data,
            samples=self.samples,
            method=self.method,
        )

    def __setstate__(self, state: dict) -> None:
        state.setdefault("method", ResamplingMethod.jackknife)
        for key, value in state.items():
            setattr(self, key, value)

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, type(self)):
            return NotImplemented
        return (
            self.binning == other.binning
            and self.method == other.method
            and np.array_equal(self.data, other.data, equal_nan=True)
            and np.array_equal(self.samples, other.samples, equal_nan=True)
        )

    __hash__ = None

    def __add__(self, other: Any) -> Self:
        if not isinstance(other, type(self)):
            return NotImplemented
        self.is_compatible(other, require=True)
        return type(self)(
            self.binning.copy(),
            self.data + other.data,
            self.samples + other.samples,
            method=self.method,
        )

    def __sub__(self, other: Any) -> Self:
        if not isinstance(other, type(self)):
            return NotImplemented
        self.is_compatible(other, require=True)
        return type(self)(
            self.binning.copy(),
            self.data - other.data,
            self.samples - other.samples,
            method=self.method,
        )

    def _make_bin_slice(self, item: TypeSliceIndex) -> Self:
        if not isinstance(item, (int, np.integer, slice)):
            raise TypeError("item selector must be a slice or integer type")
        cls = type(self)
        new = cls.__new__(cls)
        new.binning = self.binning[item]
        new.data = np.atleast_1d(self.data[item])
        new.method = self.method
        samples = self.samples[:, item]
        new.samples = (
            np.atleast_2d(samples).T if samples.ndim == 1 else samples
        )
        return new

    def is_compatible(self, other: Any, *, require: bool = False) -> bool:
        """Compatible = same binning and same number of samples."""
        if not super().is_compatible(other, require=require):
            return False
        if self.num_samples != other.num_samples:
            if require:
                raise ValueError("number of samples do not agree")
            return False
        return True


class CorrData(AsciiSerializable, SampledData):
    """A correlation function (or similar binned statistic) with samples,
    serialisable to the reference's three-file ASCII format."""

    __slots__ = ()  # storage slots live on SampledData

    @property
    def _description_data(self) -> str:
        return "correlation function with symmetric 68% percentile confidence"

    @property
    def _description_samples(self) -> str:
        return f"{self.num_samples} correlation function {self.method} samples"

    @property
    def _description_covariance(self) -> str:
        n = self.num_bins
        return f"correlation function covariance matrix ({n}x{n})"

    @classmethod
    def from_files(cls: type[Self], path_prefix: Path | str) -> Self:
        """Restore from ``[path_prefix].dat`` and ``[path_prefix].smp``."""
        logger.info("reading %s from: %s.{dat,smp}", cls.__name__, path_prefix)
        path_prefix = Path(path_prefix)

        edges, closed, data, _ = _load_data_file(path_prefix.with_suffix(".dat"))
        samples, method = _load_samples_file(path_prefix.with_suffix(".smp"))
        return cls(Binning(edges, closed=closed), data, samples, method=method)

    def to_files(self, path_prefix: Path | str) -> None:
        """Write ``.dat`` (edges, data, error), ``.smp`` (samples) and
        ``.cov`` (covariance matrix, informational).

        Root-only in multi-process jobs (all processes hold identical
        replicated results); the collective outcome broadcast synchronises
        the processes and re-raises a root-side write error everywhere."""
        from yet_another_wizz_tpu_torch.parallel.distributed import run_on_root

        def write_on_root() -> None:
            logger.info(
                "writing %s to: %s.{dat,smp,cov}",
                type(self).__name__, path_prefix,
            )
            prefix = Path(path_prefix)
            closed = str(self.binning.closed)

            # one covariance evaluation serves both the error column and
            # the .cov file
            covariance = self.covariance
            error = np.sqrt(np.diag(covariance))

            _write_data_file(
                prefix.with_suffix(".dat"),
                self._description_data,
                self.binning.left,
                self.binning.right,
                self.data,
                error,
                closed,
            )
            _write_samples_file(
                prefix.with_suffix(".smp"),
                self._description_samples,
                self.binning.left,
                self.binning.right,
                self.samples,
                closed,
                label="jack" if self.method == ResamplingMethod.jackknife
                else "boot",
            )
            _write_covariance_file(
                prefix.with_suffix(".cov"),
                self._description_covariance,
                covariance,
            )

        run_on_root(write_on_root)


# ASCII format helpers (format identical to the reference implementation,
# yaw/correlation/corrdata.py:498-605)


def _column_header(columns: list[str], closed: str) -> list[str]:
    brackets = ["[z_low", "z_high)"] if closed == "left" else ["(z_low", "z_high]"]
    return brackets + columns


def _write_header(f, description: str, columns: list[str]) -> None:
    line = " ".join(f"{col:>{PRECISION}s}" for col in columns)
    f.write(f"# {description}\n")
    f.write(f"#{line[1:]}\n")


def _read_header(path: Path) -> tuple[str, list[str], str]:
    with path.open() as f:
        description = f.readline().lstrip("#").strip()
        columns = f.readline().lstrip("#").strip().split()
    closed = "left" if columns[0][0] == "[" else "right"
    return description, columns, closed


def _write_data_file(path, description, zleft, zright, data, error, closed):
    with Path(path).open("w") as f:
        _write_header(f, description, _column_header(["nz", "nz_err"], closed))
        for row in zip(zleft, zright, data, error):
            f.write(
                " ".join(format_float_fixed_width(v, PRECISION) for v in row)
                + "\n"
            )


def _load_data_file(path):
    _, _, closed = _read_header(Path(path))
    # ndmin: a single-bin file must not collapse to a 1-D row
    zleft, zright, data, error = np.loadtxt(path, ndmin=2).T
    edges = np.append(zleft, zright[-1])
    return edges, closed, data, error


def _write_samples_file(
    path, description, zleft, zright, samples, closed, label="jack"
):
    with Path(path).open("w") as f:
        columns = [f"{label}_{i}" for i in range(len(samples))]
        _write_header(f, description, _column_header(columns, closed))
        for lo, hi, sample_col in zip(zleft, zright, samples.T):
            values = [
                format_float_fixed_width(lo, PRECISION),
                format_float_fixed_width(hi, PRECISION),
            ]
            values.extend(
                format_float_fixed_width(v, PRECISION) for v in sample_col
            )
            f.write(" ".join(values) + "\n")


def _load_samples_file(path):
    # ndmin: a single-bin file must not collapse to a 1-D row
    samples = np.loadtxt(path, ndmin=2).T[2:]  # strip the binning columns
    # the description line records the resampling method that produced the
    # samples (e.g. "64 correlation function jackknife samples")
    method = ResamplingMethod.jackknife
    with Path(path).open() as f:
        first = f.readline()
    for candidate in ResamplingMethod:
        if str(candidate.value) in first:
            method = candidate
            break
    return samples, method


def _write_covariance_file(path, description, covariance):
    with Path(path).open("w") as f:
        f.write(f"# {description}\n")
        for row in covariance:
            f.write(" ".join(f"{v: .{PRECISION - 3}e}" for v in row) + " \n")
