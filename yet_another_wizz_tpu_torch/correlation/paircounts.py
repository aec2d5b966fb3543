"""Containers for pair counts per redshift bin and patch pair.

Capability parity with the reference ``yaw.correlation.paircounts``
(yaw/correlation/paircounts.py:46-666): the
``(num_bins, num_patches, num_patches)`` count tensors, the sum-of-weights
normalisation with the autocorrelation triangle/half-diagonal rules, the
leave-one-out jackknife realised as index-free tensor algebra, sparse
nonzero-pair HDF5 serialisation with v2 legacy-format readers, and the
normalised-count wrappers (:class:`NormalisedCounts`,
:class:`NormalisedScalarCounts`).

Extension over the reference: patch **bootstrap** resampling (dropped in
the reference's v3; required by BASELINE.md config #3) implemented as an
einsum over patch multiplicity vectors.
"""

from __future__ import annotations

from abc import abstractmethod
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.binning import Binning, load_legacy_binning
from yet_another_wizz_tpu_torch.correlation.corrdata import SampledData
from yet_another_wizz_tpu_torch.options import ResamplingMethod
from yet_another_wizz_tpu_torch.utils import (
    HDF_COMPRESSION,
    is_legacy_dataset,
    load_version_tag,
    write_version_tag,
)
from yet_another_wizz_tpu_torch.utils.abc import (
    BinwiseData,
    HdfSerializable,
    PatchwiseData,
)

if TYPE_CHECKING:
    from typing import Any

    from h5py import Group
    from numpy.typing import NDArray
    from typing_extensions import Self

    from yet_another_wizz_tpu_torch.utils.abc import TypeSliceIndex

__all__ = [
    "BinwisePatchwiseArray",
    "NormalisedCounts",
    "NormalisedScalarCounts",
    "PatchedCounts",
    "PatchedSumWeights",
    "bootstrap_multiplicities",
]

DEFAULT_NUM_BOOTSTRAP = 500
BOOTSTRAP_SEED = 12345


def _as_index_list(item: TypeSliceIndex) -> TypeSliceIndex:
    """Normalise an integer index to a one-element list so that slicing a
    tensor axis never drops the axis."""
    return [item] if isinstance(item, int) else item


def _check_tensor_shape(
    name: str, array: NDArray, num_bins: int, ndim: int
) -> NDArray:
    """Coerce a per-bin tensor to float64 and check its layout: ``ndim``
    axes total, bins leading, and (for 3-dim count tensors) square patch
    axes."""
    array = np.asarray(array, dtype=np.float64)
    if array.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} axes, got {array.ndim}")
    if array.shape[0] != num_bins:
        raise ValueError(
            f"{name}: leading axis ({array.shape[0]}) must equal the "
            f"number of redshift bins ({num_bins})"
        )
    if ndim == 3 and array.shape[1] != array.shape[2]:
        raise ValueError(
            f"{name}: patch axes must be square, got {array.shape[1:]}"
        )
    return array


def bootstrap_multiplicities(
    num_patches: int,
    num_samples: int = DEFAULT_NUM_BOOTSTRAP,
    seed: int = BOOTSTRAP_SEED,
) -> NDArray:
    """Patch multiplicity vectors for bootstrap resampling.

    Each of the ``num_samples`` rows counts how often every patch appears
    when drawing ``num_patches`` patches with replacement.
    """
    rng = np.random.default_rng(seed)
    draws = rng.integers(0, num_patches, size=(num_samples, num_patches))
    mult = np.zeros((num_samples, num_patches), dtype=np.float64)
    for i, row in enumerate(draws):
        mult[i] = np.bincount(row, minlength=num_patches)
    return mult


class BinwisePatchwiseArray(BinwiseData, PatchwiseData, HdfSerializable):
    """Base class for data with shape (bins, patches, patches) supporting
    patch-resampled sums."""

    __slots__ = ()

    @property
    @abstractmethod
    def auto(self) -> bool:
        """Whether the data describes an autocorrelation measurement."""

    @abstractmethod
    def get_array(self) -> NDArray:
        """Dense representation with shape (num_bins, num_patches,
        num_patches); element [b, i, j] pairs patch i of catalog 1 with
        patch j of catalog 2 in redshift bin b."""

    @abstractmethod
    def __eq__(self, other: Any) -> bool:
        pass

    __hash__ = None

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(auto={self.auto}, "
            f"binning={self.binning}, num_patches={self.num_patches})"
        )

    def is_compatible(self, other: Any, *, require: bool = False) -> bool:
        """Compatible = same binning and number of patches."""
        binwise_ok = BinwiseData.is_compatible(self, other, require=require)
        return binwise_ok and PatchwiseData.is_compatible(
            self, other, require=require
        )

    def sample_patch_sum(
        self,
        method: ResamplingMethod | str = ResamplingMethod.jackknife,
        num_samples: int | None = None,
        seed: int = BOOTSTRAP_SEED,
    ) -> SampledData:
        """Total over all patch pairs per bin, with patch-resampled samples.

        Jackknife: leave-one-out samples computed without materialising the
        resampled tensors — sample k is ``total - row_k - col_k + diag_k``
        over the patch axes. Bootstrap: patches are drawn with replacement
        and pairs weighted by the product of patch multiplicities.
        """
        method = ResamplingMethod(method)
        array = self.get_array()
        totals = np.einsum("bij->b", array)

        if method == ResamplingMethod.jackknife:
            row_sums = np.einsum("bij->jb", array)
            col_sums = np.einsum("bij->ib", array)
            diagonals = np.einsum("bii->ib", array)
            samples = (totals[None, :] - row_sums - col_sums) + diagonals
        else:
            mult = bootstrap_multiplicities(
                self.num_patches,
                num_samples or DEFAULT_NUM_BOOTSTRAP,
                seed,
            )
            samples = np.einsum("bij,ri,rj->rb", array, mult, mult)

        return SampledData(self.binning, totals, samples, method=method)


class PatchedSumWeights(BinwisePatchwiseArray):
    """Sum of catalog weights per redshift bin and patch, for both catalogs
    of a correlation measurement; the outer product normalises pair counts.

    For autocorrelations the product matrix is upper-triangled with a half
    diagonal to match the pair counting conventions.
    """

    __slots__ = ("auto", "binning", "sum_weights1", "sum_weights2")

    def __init__(
        self, binning: Binning, sum_weights1: NDArray,
        sum_weights2: NDArray, *, auto: bool,
    ) -> None:
        self.binning = binning
        self.auto = auto
        self.sum_weights1 = _check_tensor_shape(
            "sum_weights1", sum_weights1, self.num_bins, ndim=2
        )
        self.sum_weights2 = _check_tensor_shape(
            "sum_weights2", sum_weights2, self.num_bins, ndim=2
        )
        if self.sum_weights1.shape != self.sum_weights2.shape:
            raise ValueError(
                "the two sum-of-weights arrays disagree in shape: "
                f"{self.sum_weights1.shape} vs {self.sum_weights2.shape}"
            )

    @property
    def num_patches(self) -> int:
        return self.sum_weights1.shape[1]

    def get_array(self) -> NDArray:
        array = self.sum_weights1[:, :, None] * self.sum_weights2[:, None, :]
        if self.auto:
            # pairs are only counted for patch id2 >= id1, with same-patch
            # pairs halved — weight the product matrix with the identical
            # convention so counts/norm stays an unbiased estimator
            num = self.num_patches
            convention = np.triu(np.ones((num, num)), k=1) + 0.5 * np.eye(num)
            array = array * convention
        return array

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, type(self)):
            return NotImplemented
        if self.binning != other.binning or self.auto != other.auto:
            return False
        return np.array_equal(
            self.sum_weights1, other.sum_weights1
        ) and np.array_equal(self.sum_weights2, other.sum_weights2)

    __hash__ = None

    def _make_bin_slice(self, item: TypeSliceIndex) -> Self:
        binning = self.binning[item]
        rows = _as_index_list(item)
        return type(self)(
            binning,
            self.sum_weights1[rows],
            self.sum_weights2[rows],
            auto=self.auto,
        )

    def _make_patch_slice(self, item: TypeSliceIndex) -> Self:
        cols = _as_index_list(item)
        return type(self)(
            self.binning,
            self.sum_weights1[:, cols],
            self.sum_weights2[:, cols],
            auto=self.auto,
        )

    # ---- HDF5 round trip -----------------------------------------------

    def to_hdf(self, dest: Group) -> None:
        write_version_tag(dest)
        dest.create_dataset(
            "sum_weights1", data=self.sum_weights1, **HDF_COMPRESSION
        )
        dest.create_dataset(
            "sum_weights2", data=self.sum_weights2, **HDF_COMPRESSION
        )
        dest.create_dataset("auto", data=self.auto)
        self.binning.to_hdf(dest.create_group("binning"))

    @classmethod
    def from_hdf(cls: type[Self], source: Group) -> Self:
        auto = bool(source["auto"][()])
        if is_legacy_dataset(source):
            return cls(
                load_legacy_binning(source),
                np.transpose(source["totals1"][:]),
                np.transpose(source["totals2"][:]),
                auto=auto,
            )
        return cls(
            Binning.from_hdf(source["binning"]),
            source["sum_weights1"][:],
            source["sum_weights2"][:],
            auto=auto,
        )


class PatchedCounts(BinwisePatchwiseArray):
    """Weighted pair counts per redshift bin and patch pair."""

    __slots__ = ("auto", "binning", "counts")

    def __init__(
        self, binning: Binning, counts: NDArray, *, auto: bool
    ) -> None:
        self.binning = binning
        self.auto = auto
        self.counts = _check_tensor_shape(
            "counts", counts, self.num_bins, ndim=3
        )

    @classmethod
    def zeros(
        cls: type[Self], binning: Binning, num_patches: int, *, auto: bool
    ) -> Self:
        """New instance with all counts zero."""
        shape = (len(binning), num_patches, num_patches)
        return cls(binning, np.zeros(shape), auto=auto)

    @property
    def num_patches(self) -> int:
        return self.counts.shape[1]

    def get_array(self) -> NDArray:
        return self.counts

    def set_patch_pair(
        self, patch_id1: int, patch_id2: int, counts_binned: NDArray
    ) -> None:
        """Assign the per-bin counts for one pair of patches."""
        self.counts[:, patch_id1, patch_id2] = counts_binned

    # ---- arithmetic and slicing ------------------------------------------

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, type(self)):
            return NotImplemented
        if self.binning != other.binning or self.auto != other.auto:
            return False
        return np.array_equal(self.counts, other.counts)

    __hash__ = None

    def __add__(self, other: Any) -> Self:
        if not isinstance(other, type(self)):
            return NotImplemented
        self.is_compatible(other, require=True)
        return type(self)(
            self.binning, self.counts + other.counts, auto=self.auto
        )

    def __mul__(self, factor: float) -> Self:
        return type(self)(self.binning, self.counts * factor, auto=self.auto)

    def _make_bin_slice(self, item: TypeSliceIndex) -> Self:
        binning = self.binning[item]
        return type(self)(
            binning, self.counts[_as_index_list(item)], auto=self.auto
        )

    def _make_patch_slice(self, item: TypeSliceIndex) -> Self:
        keep = _as_index_list(item)
        sub = self.counts[:, keep, :][:, :, keep]
        return type(self)(self.binning, sub, auto=self.auto)

    # ---- HDF5 round trip -----------------------------------------------

    def to_hdf(self, dest: Group) -> None:
        write_version_tag(dest)
        # sparse storage: only patch pairs with counts in any bin
        ids1, ids2 = np.nonzero(np.any(self.counts, axis=0))
        dest.create_dataset(
            "patch_pairs",
            data=np.column_stack([ids1, ids2]),
            **HDF_COMPRESSION,
        )
        binned = np.moveaxis(self.counts[:, ids1, ids2], 0, -1)
        dest.create_dataset("binned_counts", data=binned, **HDF_COMPRESSION)
        dest.create_dataset("num_patches", data=self.num_patches)
        dest.create_dataset("auto", data=self.auto)
        self.binning.to_hdf(dest.create_group("binning"))

    @classmethod
    def from_hdf(cls: type[Self], source: Group) -> Self:
        auto = bool(source["auto"][()])
        if is_legacy_dataset(source):
            binning = load_legacy_binning(source)
            num_patches = int(source["n_patches"][()])
            patch_pairs = source["keys"][:]
            binned_counts = source["data"][:]
        else:
            binning = Binning.from_hdf(source["binning"])
            num_patches = int(source["num_patches"][()])
            patch_pairs = source["patch_pairs"][:]
            binned_counts = source["binned_counts"][:]

        new = cls.zeros(binning, num_patches, auto=auto)
        for (id1, id2), counts in zip(patch_pairs, binned_counts):
            new.set_patch_pair(id1, id2, counts)
        return new


class BaseNormalisedCounts(BinwisePatchwiseArray):
    """A pair of containers: raw counts and their normalisation."""

    __slots__ = ("_counts", "_norm")

    def _init(
        self, counts: BinwisePatchwiseArray, norm: BinwisePatchwiseArray
    ) -> None:
        for axis in ("num_patches", "num_bins"):
            n_counts = getattr(counts, axis)
            n_norm = getattr(norm, axis)
            if n_counts != n_norm:
                raise ValueError(
                    f"counts and normalisation disagree in {axis}: "
                    f"{n_counts} vs {n_norm}"
                )
        self._counts = counts
        self._norm = norm

    # the wrapped pair delegates its binning/patch/auto identity
    binning = property(lambda self: self._counts.binning)
    auto = property(lambda self: self._counts.auto)
    num_patches = property(lambda self: self._counts.num_patches)

    def is_compatible(self, other: Any, *, require: bool = False) -> bool:
        if type(self) is not type(other):
            if not require:
                return False
            raise TypeError(
                f"{type(other)} is not compatible with {type(self)}"
            )
        return self._counts.is_compatible(other._counts, require=require)

    def get_array(self) -> NDArray:
        """Counts normalised by the *total* patch-summed normalisation."""
        # only the totals are needed — skip the full jackknife resampling
        # that sample_patch_sum would compute alongside them
        norm = np.einsum("bij->b", self._norm.get_array())
        return self._counts.get_array() / norm[:, None, None]

    def sample_patch_sum(
        self,
        method: ResamplingMethod | str = ResamplingMethod.jackknife,
        num_samples: int | None = None,
        seed: int = BOOTSTRAP_SEED,
    ) -> SampledData:
        """Normalised patch totals: counts / normalisation evaluated on the
        totals and consistently on every resampled realisation."""
        counts = self._counts.sample_patch_sum(method, num_samples, seed)
        norm = self._norm.sample_patch_sum(method, num_samples, seed)
        return SampledData(
            self.binning,
            counts.data / norm.data,
            counts.samples / norm.samples,
            method=method,
        )

    # ---- arithmetic and slicing ------------------------------------------

    def __eq__(self, other: Any) -> bool:
        if type(self) is not type(other):
            return NotImplemented
        return self._counts == other._counts and self._norm == other._norm

    __hash__ = None

    def __add__(self, other: Any) -> Self:
        if type(self) is not type(other):
            return NotImplemented
        if self._norm != other._norm:
            raise ValueError("normalisation of operands does not match")
        return type(self)(self._counts + other._counts, self._norm)

    def __mul__(self, factor: float) -> Self:
        return type(self)(self._counts * factor, self._norm)

    def _make_bin_slice(self, item: TypeSliceIndex) -> Self:
        return type(self)(self._counts.bins[item], self._norm.bins[item])

    def _make_patch_slice(self, item: TypeSliceIndex) -> Self:
        return type(self)(
            self._counts.patches[item], self._norm.patches[item]
        )

    # ---- HDF5 round trip -----------------------------------------------

    @classmethod
    @abstractmethod
    def _hdf_group_names(cls, version_tag: str) -> tuple[str, str]:
        """HDF5 group names for the counts and normalisation containers."""

    def to_hdf(self, dest: Group) -> None:
        write_version_tag(dest)
        counts_name, norm_name = self._hdf_group_names(load_version_tag(dest))
        self._counts.to_hdf(dest.create_group(counts_name))
        self._norm.to_hdf(dest.create_group(norm_name))


class NormalisedCounts(BaseNormalisedCounts):
    """Pair counts normalised by the product of catalog sums of weights."""

    __slots__ = ()  # storage lives in BaseNormalisedCounts

    def __init__(self, counts: PatchedCounts, sum_weights: PatchedSumWeights):
        self._init(counts, sum_weights)

    #: The raw pair counts.
    counts = property(lambda self: self._counts)
    #: The sum-of-weights normalisation.
    sum_weights = property(lambda self: self._norm)

    @classmethod
    def _hdf_group_names(cls, version_tag: str) -> tuple[str, str]:
        if version_tag.startswith("2"):
            return ("count", "total")
        return ("counts", "sum_weights")

    @classmethod
    def from_hdf(cls: type[Self], source: Group) -> Self:
        counts_name, norm_name = cls._hdf_group_names(load_version_tag(source))
        return cls(
            PatchedCounts.from_hdf(source[counts_name]),
            PatchedSumWeights.from_hdf(source[norm_name]),
        )


class NormalisedScalarCounts(BaseNormalisedCounts):
    """Scalar-field (kappa) weighted pair counts normalised by the plain
    number pair counts."""

    __slots__ = ()  # storage lives in BaseNormalisedCounts

    def __init__(
        self, kappa_counts: PatchedCounts, number_counts: PatchedCounts
    ):
        self._init(kappa_counts, number_counts)

    #: Pair counts weighted by the scalar field.
    kappa_counts = property(lambda self: self._counts)
    #: Plain pair counts used for normalisation.
    number_counts = property(lambda self: self._norm)

    @classmethod
    def _hdf_group_names(cls, version_tag: str) -> tuple[str, str]:
        return ("kappa_counts", "number_counts")

    @classmethod
    def from_hdf(cls: type[Self], source: Group) -> Self:
        counts_name, norm_name = cls._hdf_group_names(load_version_tag(source))
        return cls(
            PatchedCounts.from_hdf(source[counts_name]),
            PatchedCounts.from_hdf(source[norm_name]),
        )
