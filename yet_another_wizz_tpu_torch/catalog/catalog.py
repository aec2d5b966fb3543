"""Patch-resolved catalogs: the main data container for measurements.

Ported from the JAX package's ``catalog/catalog.py`` for the in-memory
path: :meth:`Catalog.from_arrays` with the three patch-creation modes
(apply given centers / use patch ids / generate centers with kmeans), the
``Mapping[int, Patch]`` interface, patch geometry, per-bin weight sums and
:meth:`Catalog.get_tiles`, which packs the catalog into the point tiles of
the pair-count engine (:class:`~yet_another_wizz_tpu_torch.ops.tiles.TileSet`,
the replacement for the reference's per-patch kd-trees; cached per
(binning, counting-mode) fingerprint). File readers and the on-disk patch
cache are not ported yet.
"""

from __future__ import annotations

import logging
from collections.abc import Mapping
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.coordinates import (
    AngularCoordinates,
    AngularDistances,
    radec_to_xyz,
)
from yet_another_wizz_tpu_torch.datachunk import DataChunk, check_patch_ids
from yet_another_wizz_tpu_torch.catalog.patch import Metadata
from yet_another_wizz_tpu_torch.ops.kmeans import assign_patches, kmeans_patch_centers
from yet_another_wizz_tpu_torch.ops.tiles import DEFAULT_TILE_SIZE, build_tile_set

if TYPE_CHECKING:
    from collections.abc import Iterator

    import torch
    from numpy.typing import ArrayLike, NDArray
    from typing_extensions import Self

    from yet_another_wizz_tpu_torch.binning import Binning
    from yet_another_wizz_tpu_torch.ops.tiles import TileSet

__all__ = [
    "Catalog",
    "InconsistentPatchesError",
    "MemoryPatch",
]

logger = logging.getLogger(__name__)

DEFAULT_PROBE_SIZE = 500_000


class InconsistentPatchesError(Exception):
    """Patch centers or ids of two catalogs do not match."""


class MemoryPatch:
    """In-memory view of one patch of a catalog (the accessor interface of
    the JAX package's disk-backed ``Patch``)."""

    __slots__ = ("_chunk", "meta")

    def __init__(self, chunk: NDArray, center: AngularCoordinates | None) -> None:
        self._chunk = chunk
        self.meta = Metadata.compute(
            DataChunk.get_coords(chunk),
            weights=DataChunk.getattr(chunk, "weights"),
            center=center,
        )

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.meta})"

    def load_data(self) -> NDArray:
        return self._chunk

    @property
    def coords(self) -> AngularCoordinates:
        return DataChunk.get_coords(self._chunk)

    @property
    def weights(self) -> NDArray | None:
        return DataChunk.getattr(self._chunk, "weights")

    @property
    def redshifts(self) -> NDArray | None:
        return DataChunk.getattr(self._chunk, "redshifts")

    @property
    def kappa(self) -> NDArray | None:
        return DataChunk.getattr(self._chunk, "kappa")

    @property
    def has_weights(self) -> bool:
        return "weights" in self._chunk.dtype.fields

    @property
    def has_redshifts(self) -> bool:
        return "redshifts" in self._chunk.dtype.fields

    @property
    def has_kappa(self) -> bool:
        return "kappa" in self._chunk.dtype.fields


def _resolve_patch_assignment(
    xyz: NDArray,
    weights: NDArray | None,
    *,
    patch_centers,
    patch_ids,
    patch_num,
    probe_size: int,
    device: torch.device | str,
) -> tuple[NDArray, NDArray]:
    """Determine patch ids and centers using the reference's priority:
    explicit centers > explicit ids > kmeans-generated centers. Large
    catalogs are assigned to their centers on ``device``."""
    if patch_centers is not None:
        if isinstance(patch_centers, Catalog):
            centers_xyz = patch_centers.get_centers().to_3d()
        elif isinstance(patch_centers, AngularCoordinates):
            centers_xyz = patch_centers.to_3d()
        else:
            centers_xyz = np.asarray(patch_centers, dtype=np.float64)
            if centers_xyz.ndim != 2 or centers_xyz.shape[1] not in (2, 3):
                raise ValueError(
                    "'patch_centers' must be AngularCoordinates, a Catalog, "
                    "or an array of shape (P, 2) radian / (P, 3) unit vectors"
                )
            if centers_xyz.shape[1] == 2:
                centers_xyz = radec_to_xyz(
                    centers_xyz[:, 0], centers_xyz[:, 1]
                )
        ids = assign_patches(xyz, centers_xyz, device=device)
        return ids, centers_xyz

    if patch_ids is not None:
        ids = np.asarray(patch_ids)
        if len(ids) != len(xyz):
            raise ValueError("length of 'patch_ids' does not match catalog")
        check_patch_ids(ids)
        num = int(ids.max()) + 1 if len(ids) else 0
        centers_xyz = np.zeros((num, 3))
        for pid in range(num):
            sel = ids == pid
            if not np.any(sel):
                continue
            mean = np.average(xyz[sel], axis=0, weights=(
                weights[sel] if weights is not None else None
            ))
            centers_xyz[pid] = mean / np.linalg.norm(mean)
        return ids.astype(np.int32), centers_xyz

    if patch_num is not None:
        logger.info("computing %d patch centers with kmeans", patch_num)
        centers_xyz = kmeans_patch_centers(
            xyz, patch_num, weights=weights, probe_size=probe_size,
            device=device,
        )
        ids = assign_patches(xyz, centers_xyz, device=device)
        return ids, centers_xyz

    raise ValueError(
        "exactly one of 'patch_centers', 'patch_name'/'patch_ids', or "
        "'patch_num' is required"
    )


class Catalog(Mapping):
    """A point catalog split into spatial patches.

    Create instances with :meth:`from_arrays`. Iterating/indexing yields
    per-patch views.
    """

    __slots__ = (
        "_chunk",
        "_xyz",
        "_patch_ids",
        "patch_centers_xyz",
        "patch_radii",
        "num_patches",
        "_tile_cache",
        "_bin_sums_cache",
    )

    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "reopening a catalog cache is not ported yet; use "
            "Catalog.from_arrays"
        )

    @classmethod
    def from_arrays(
        cls: type[Self],
        ra: ArrayLike,
        dec: ArrayLike,
        *,
        weights: ArrayLike | None = None,
        redshifts: ArrayLike | None = None,
        kappa: ArrayLike | None = None,
        degrees: bool = True,
        patch_centers=None,
        patch_ids: ArrayLike | None = None,
        patch_num: int | None = None,
        probe_size: int = DEFAULT_PROBE_SIZE,
        cache_directory=None,
        device: torch.device | str = "cuda",
        **_ignored,
    ) -> Self:
        """Create a catalog from per-column arrays (the in-memory
        constructor). Catalogs large enough for the device patch
        assignment (:data:`~yet_another_wizz_tpu_torch.ops.kmeans.
        DEVICE_ASSIGN_THRESHOLD`) run it on ``device``, which raises when it
        is a CUDA device and CUDA is not available. Writing a
        ``cache_directory`` is not ported yet."""
        if cache_directory is not None:
            raise NotImplementedError("catalog caches are not ported yet")
        chunk = DataChunk.create(
            ra, dec,
            weights=weights, redshifts=redshifts, kappa=kappa,
            degrees=degrees,
        )
        new = cls.__new__(cls)
        new._chunk = chunk
        new._xyz = radec_to_xyz(chunk["ra"], chunk["dec"])
        new._tile_cache = {}

        ids, centers_xyz = _resolve_patch_assignment(
            new._xyz,
            DataChunk.getattr(chunk, "weights"),
            patch_centers=patch_centers,
            patch_ids=patch_ids,
            patch_num=patch_num,
            probe_size=probe_size,
            device=device,
        )
        new._patch_ids = np.asarray(ids, dtype=np.int32)
        new.num_patches = len(centers_xyz)
        if new.num_patches == 0:
            raise ValueError("catalog has no patches")
        check_patch_ids(new.num_patches - 1)  # int16 bound (<= 32767)

        counts = np.bincount(new._patch_ids, minlength=new.num_patches)
        if np.any(counts == 0):
            empty = np.nonzero(counts == 0)[0].tolist()
            raise ValueError(f"patches with no data: {empty}")

        new._init_patch_geometry(centers_xyz=centers_xyz)
        return new

    def _init_patch_geometry(self, centers_xyz: NDArray | None) -> None:
        """Per-patch cap centers and radii.

        With ``centers_xyz`` given (the centers that ASSIGNED the points:
        explicit, another catalog's, or kmeans-generated), those are
        retained as the patch centers and only the radii are computed —
        matching the reference, whose ``get_centers()`` returns the
        applied centers (yaw/catalog/catalog.py:334-374).
        Recomputed weighted means would drift off the assignment Voronoi
        seeds, so catalogs patched with ``other.get_centers()`` would use
        different boundaries than ``other`` itself. Without ``centers_xyz``
        (patch-id column mode) the weighted means are computed, as in the
        reference."""
        weights = DataChunk.getattr(self._chunk, "weights")
        ids = self._patch_ids
        num = self.num_patches

        from yet_another_wizz_tpu_torch import _native

        if centers_xyz is not None:
            centers = np.asarray(centers_xyz, dtype=np.float64)
            norms = np.linalg.norm(centers, axis=1, keepdims=True)
            centers = centers / np.maximum(norms, 1e-300)
            self.patch_centers_xyz = centers
            self.patch_radii = self._radii_to_centers(centers, ids, num)
            return

        if _native.enabled():
            centers, radii = _native.patch_geometry(
                self._xyz, weights, ids, num
            )
            self.patch_centers_xyz = centers
            self.patch_radii = radii
            return

        w = np.ones(len(ids)) if weights is None else weights
        sums = np.stack(
            [
                np.bincount(ids, weights=w * self._xyz[:, dim], minlength=num)
                for dim in range(3)
            ],
            axis=1,
        )
        norms = np.linalg.norm(sums, axis=1)
        centers = np.zeros((num, 3))
        centers[:, 0] = 1.0
        nonempty = norms > 0
        centers[nonempty] = sums[nonempty] / norms[nonempty, None]

        self.patch_centers_xyz = centers
        self.patch_radii = self._radii_to_centers(centers, ids, num)

    def _radii_to_centers(self, centers, ids, num) -> NDArray:
        """Angular cap radii: the maximum chord distance of each patch's
        points to the given per-patch centers."""
        from yet_another_wizz_tpu_torch import _native

        if _native.enabled():
            # per-patch max chord: reuse the tile kernel with tile size 1
            # so dest // 1 == the patch id itself
            max_chord = _native.tile_max_chord(self._xyz, ids, 1, centers)
        else:
            chord = np.linalg.norm(self._xyz - centers[ids], axis=1)
            max_chord = np.zeros(num)
            np.maximum.at(max_chord, ids, chord)
        return 2.0 * np.arcsin(np.clip(max_chord / 2.0, 0.0, 1.0))

    # -- Mapping interface over patches ------------------------------------

    def __len__(self) -> int:
        return self.num_patches

    def __getitem__(self, patch_id: int) -> MemoryPatch:
        if patch_id not in range(self.num_patches):
            raise KeyError(patch_id)
        sel = self._patch_ids == patch_id
        center = AngularCoordinates.from_3d(self.patch_centers_xyz[patch_id])
        return MemoryPatch(self._chunk[sel], center)

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.num_patches))

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(num_patches={self.num_patches}, "
            f"num_records={len(self._chunk)})"
        )

    # -- column accessors ---------------------------------------------------

    @property
    def has_weights(self) -> bool:
        return "weights" in self._chunk.dtype.fields

    @property
    def has_redshifts(self) -> bool:
        return "redshifts" in self._chunk.dtype.fields

    @property
    def has_kappa(self) -> bool:
        return "kappa" in self._chunk.dtype.fields

    @property
    def ra(self) -> NDArray:
        """Right ascension in radian."""
        return self._chunk["ra"]

    @property
    def dec(self) -> NDArray:
        """Declination in radian."""
        return self._chunk["dec"]

    @property
    def weights(self) -> NDArray | None:
        return DataChunk.getattr(self._chunk, "weights")

    @property
    def redshifts(self) -> NDArray | None:
        return DataChunk.getattr(self._chunk, "redshifts")

    @property
    def kappa(self) -> NDArray | None:
        return DataChunk.getattr(self._chunk, "kappa")

    @property
    def patch_ids(self) -> NDArray:
        """Patch id of every point."""
        return self._patch_ids

    @property
    def xyz(self) -> NDArray:
        """Unit-sphere positions, float64 of shape (N, 3)."""
        return self._xyz

    def get_num_records(self) -> tuple[int, ...]:
        """Number of points per patch."""
        counts = np.bincount(self._patch_ids, minlength=self.num_patches)
        return tuple(int(c) for c in counts)

    def get_sum_weights(self) -> tuple[float, ...]:
        """Sum of weights per patch."""
        weights = self.weights
        if weights is None:
            return tuple(float(c) for c in self.get_num_records())
        sums = np.bincount(
            self._patch_ids, weights=weights, minlength=self.num_patches
        )
        return tuple(float(s) for s in sums)

    def bin_sum_weights(self, binning, num_bins: int) -> NDArray:
        """Per (bin, patch) sum of weights, float64 ``(num_bins, P)``;
        with ``binning=None`` every bin receives the per-patch totals
        (the normalisation semantics of unbinned pair counting).

        Memoised per binning (like :meth:`LazyCatalog.bin_sum_weights`):
        the catalog data is immutable and the blocked measurement path
        calls this once per count — without the memo every measurement
        re-paid a digitize + bincount pass over the full catalog (the
        dominant term of the survey bench's flagged ``setup`` phase)."""
        key = (
            None
            if binning is None
            else (binning.edges.tobytes(), str(binning.closed))
        )
        try:
            memo = self._bin_sums_cache
        except AttributeError:  # covers every construction path
            memo = {}
            self._bin_sums_cache = memo
        cached = memo.get(key)
        if cached is not None:
            if binning is None:
                return np.broadcast_to(
                    cached, (num_bins, self.num_patches)
                ).copy()
            return cached.copy()  # callers may mutate their result

        weights = self.weights
        w = np.ones(len(self._patch_ids)) if weights is None else weights
        if binning is None:
            totals = np.bincount(
                self._patch_ids, weights=w, minlength=self.num_patches
            )
            memo[key] = totals
            return np.broadcast_to(
                totals, (num_bins, self.num_patches)
            ).copy()
        if self.redshifts is None:  # match LazyCatalog's error, not a
            raise ValueError(  # TypeError from inside np.digitize
                "catalog has no 'redshifts' attached"
            )
        zbins = binning.digitize(self.redshifts) - 1
        keep = (zbins >= 0) & (zbins < len(binning))
        flat = zbins[keep] * self.num_patches + self._patch_ids[keep]
        sums = np.bincount(
            flat, weights=w[keep], minlength=len(binning) * self.num_patches
        ).reshape(len(binning), self.num_patches)
        memo[key] = sums
        return sums.copy()

    def get_centers(self) -> AngularCoordinates:
        """Patch cap centers."""
        return AngularCoordinates.from_3d(self.patch_centers_xyz)

    def get_radii(self) -> AngularDistances:
        """Patch cap radii."""
        return AngularDistances(self.patch_radii)

    # -- device tiles (the kd-tree replacement) -----------------------------

    def drop_tile_cache(self) -> None:
        """Release all cached tile sets (and their device-resident
        copies); they are rebuilt on demand."""
        self._tile_cache.clear()

    def get_tiles(
        self,
        binning: Binning | None,
        *,
        mode: str = "n",
        tile_size: int = DEFAULT_TILE_SIZE,
        layout: str = "spatial",
    ) -> TileSet:
        """Tile set for the given binning and counting mode (cached).

        Args:
            binning: redshift binning, or None for an unbinned tile set.
            mode: ``"n"`` for number weights, ``"k"`` for scalar-field
                weights (``kappa * weights``).
            tile_size: points per device tile.
            layout: ``"spatial"`` (Morton within patch) or ``"zmajor"``
                (Morton within (patch, bin); bin-coherent tiles for the
                per-tile angular-cutoff pruning).
        """
        if binning is None:
            key = (None, None, mode, tile_size, "spatial")
        else:
            key = (
                binning.edges.tobytes(),
                str(binning.closed),
                mode,
                tile_size,
                layout,
            )
        if key in self._tile_cache:
            return self._tile_cache[key]

        weights = self.weights
        if mode == "k":
            if not self.has_kappa:
                raise ValueError("missing required 'kappa' for scalar mode")
            kappa = self.kappa
            mode_weights = kappa if weights is None else kappa * weights
        elif mode == "n":
            mode_weights = None
        else:
            raise ValueError(f"invalid counting mode '{mode}'")

        if binning is None:
            zbins, num_bins = None, 0
        else:
            if not self.has_redshifts:
                raise ValueError("catalog has no 'redshifts' attached")
            zbins = binning.digitize(self.redshifts) - 1
            num_bins = len(binning)

        tiles = build_tile_set(
            self._xyz,
            self._patch_ids,
            self.num_patches,
            weights=weights,
            zbins=zbins,
            num_bins=num_bins,
            kappa=self.kappa,
            tile_size=tile_size,
            mode_weights=mode_weights,
            layout=layout if binning is not None else "spatial",
        )
        self._tile_cache[key] = tiles
        return tiles
