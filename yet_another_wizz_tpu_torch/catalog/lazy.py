"""Disk-backed catalog with bounded host memory.

Ported from the JAX package's ``catalog/lazy.py``. The in-memory
:class:`~yet_another_wizz_tpu_torch.catalog.catalog.Catalog` holds every
column in RAM. :class:`LazyCatalog` opens the same patch cache while
reading only the per-patch ``meta.yml`` summaries (center, radius, record
count, sum of weights); patch DATA is read from ``data.bin`` on demand, one
patch block at a time, mirroring the reference's lazily loaded ``Patch``
objects (yaw/catalog/patch.py:321-420).

A lazy catalog drives the blocked (out-of-core) measurement path:
``crosscorrelate(..., max_resident_patches=N)`` and the other measurement
functions keep the host footprint bounded at one patch-block pair, so
catalogs larger than host RAM can be measured from their cache. The
full-tile (``get_tiles``) path requires the memory-resident catalog and
raises with that instruction.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.catalog.catalog import (
    BlockData,
    discover_patch_dirs,
)
from yet_another_wizz_tpu_torch.catalog.patch import Metadata, read_patch_data
from yet_another_wizz_tpu_torch.coordinates import (
    AngularCoordinates,
    AngularDistances,
    radec_to_xyz,
)
from yet_another_wizz_tpu_torch.datachunk import (
    DataChunk,
    DataChunkInfo,
    HandlesDataChunk,
    check_patch_ids,
)

if TYPE_CHECKING:
    from numpy.typing import NDArray

    from yet_another_wizz_tpu_torch.binning import Binning

__all__ = [
    "LazyCatalog",
]

logger = logging.getLogger(__name__)


class LazyCatalog(HandlesDataChunk):
    """A patch cache opened without loading the data rows.

    Construction reads only the per-patch metadata (and one header byte of
    the first ``data.bin`` for the column layout). Patch data is loaded on
    demand through :meth:`load_block`; per-bin normalisation sums are
    computed in one bounded-memory pass per binning and memoised.
    """

    __slots__ = (
        "cache_directory",
        "num_patches",
        "patch_centers_xyz",
        "patch_radii",
        "_num_records",
        "_sum_weights",
        "_chunk_info",
        "_patch_paths",
        "_bin_sums_cache",
        # weakref support (for the blocked path's tile-cache keys) comes
        # from the slot-less HandlesDataChunk base
    )

    def __init__(self, cache_directory: Path | str) -> None:
        self.cache_directory = Path(cache_directory)
        logger.info("lazily opening cache directory: %s", cache_directory)
        patch_dirs = discover_patch_dirs(
            self.cache_directory, require_contiguous=True
        )

        self.num_patches = len(patch_dirs)
        check_patch_ids(self.num_patches - 1)
        self._patch_paths = tuple(patch_dirs)

        centers = np.empty((self.num_patches, 3))
        radii = np.empty(self.num_patches)
        num_records = []
        sum_weights = []
        for pid, path in enumerate(patch_dirs):
            meta = Metadata.from_file(path / "meta.yml")
            centers[pid] = meta.center.to_3d()
            radii[pid] = meta.radius.data[0]
            num_records.append(int(meta.num_records))
            sum_weights.append(float(meta.sum_weights))
        self.patch_centers_xyz = centers
        self.patch_radii = radii
        self._num_records = tuple(num_records)
        self._sum_weights = tuple(sum_weights)

        with (patch_dirs[0] / "data.bin").open("rb") as f:
            self._chunk_info = DataChunkInfo.from_bytes(f.read(1))
        self._bin_sums_cache = {}

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(num_patches={self.num_patches}, "
            f"num_records={sum(self._num_records)}) "
            f"@ {self.cache_directory}"
        )

    def __len__(self) -> int:
        return self.num_patches

    # -- metadata accessors (no data reads; has_weights/has_redshifts/
    # has_kappa come from the HandlesDataChunk mixin) -----------------------

    def get_num_records(self) -> tuple[int, ...]:
        """Number of points per patch (from the patch metadata)."""
        return self._num_records

    def get_sum_weights(self) -> tuple[float, ...]:
        """Sum of weights per patch (from the patch metadata)."""
        return self._sum_weights

    def get_centers(self) -> AngularCoordinates:
        """Patch cap centers."""
        return AngularCoordinates.from_3d(self.patch_centers_xyz)

    def get_radii(self) -> AngularDistances:
        """Patch cap radii."""
        return AngularDistances(self.patch_radii)

    # -- on-demand data access ----------------------------------------------

    def _load_patch(self, pid: int) -> NDArray:
        _, data = read_patch_data(self._patch_paths[pid] / "data.bin")
        return data

    def load_block(self, patch_lo: int, patch_hi: int) -> BlockData:
        """Read the patches in ``[patch_lo, patch_hi)`` from the cache,
        with patch ids rebased to the block. Host memory is bounded by the
        block size regardless of the catalog size.

        Out-of-range bounds clamp to the valid patch range, matching the
        resident :meth:`Catalog.load_block` (whose mask-based selection
        clamps implicitly)."""
        patch_lo = max(0, patch_lo)
        patch_hi = min(self.num_patches, patch_hi)
        if patch_hi <= patch_lo:
            raise ValueError(f"empty patch block [{patch_lo}, {patch_hi})")
        chunks = [self._load_patch(pid) for pid in range(patch_lo, patch_hi)]
        data = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        patch_ids = np.repeat(
            np.arange(patch_hi - patch_lo, dtype=np.int32),
            [len(c) for c in chunks],
        )
        return BlockData(
            xyz=radec_to_xyz(data["ra"], data["dec"]),
            patch_ids=patch_ids,
            weights=DataChunk.getattr(data, "weights"),
            redshifts=DataChunk.getattr(data, "redshifts"),
            kappa=DataChunk.getattr(data, "kappa"),
        )

    def bin_sum_weights(self, binning: Binning | None, num_bins: int) -> NDArray:
        """Per (bin, patch) sum of weights, float64 ``(num_bins, P)``,
        computed in one pass over the cache (one patch resident at a time)
        and memoised per binning."""
        if binning is None:
            totals = np.asarray(self._sum_weights)
            return np.broadcast_to(totals, (num_bins, self.num_patches)).copy()

        key = (binning.edges.tobytes(), str(binning.closed))
        cached = self._bin_sums_cache.get(key)
        if cached is not None:
            return cached.copy()  # callers may mutate their result

        sums = np.zeros((len(binning), self.num_patches))
        for pid in range(self.num_patches):
            data = self._load_patch(pid)
            redshifts = DataChunk.getattr(data, "redshifts")
            if redshifts is None:
                raise ValueError("catalog has no 'redshifts' attached")
            weights = DataChunk.getattr(data, "weights")
            w = np.ones(len(data)) if weights is None else weights
            zbins = binning.digitize(redshifts) - 1
            keep = (zbins >= 0) & (zbins < len(binning))
            sums[:, pid] = np.bincount(
                zbins[keep], weights=w[keep], minlength=len(binning)
            )
        self._bin_sums_cache[key] = sums
        return sums.copy()

    # -- guards for paths that need the resident catalog ---------------------

    def get_tiles(self, *args, **kwargs):
        raise NotImplementedError(
            "a LazyCatalog reads patch data on demand and cannot build "
            "full-catalog device tiles; run the measurement with "
            "max_resident_patches=N (the blocked out-of-core path), or "
            "open the cache with Catalog(cache_directory) to load it "
            "into memory"
        )

    build_trees = get_tiles
