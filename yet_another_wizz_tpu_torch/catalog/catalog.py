"""Patch-resolved catalogs: the main data container for measurements.

Ported from the JAX package's ``catalog/catalog.py`` for the in-memory
path: :meth:`Catalog.from_arrays` with the three patch-creation modes
(apply given centers / use patch ids / generate centers with kmeans), the
``Mapping[int, Patch]`` interface, patch geometry, per-bin weight sums and
:meth:`Catalog.get_tiles`, which packs the catalog into the point tiles of
the pair-count engine (:class:`~yet_another_wizz_tpu_torch.ops.tiles.TileSet`,
the replacement for the reference's per-patch kd-trees; cached per
(binning, counting-mode) fingerprint), and :meth:`Catalog.build_trees`,
which builds ahead of a measurement the tile sets it will ask for and, on a
card, uploads them. The constructors from files,
dataframes and random generators, the on-disk patch cache
(``patch_{i}/data.bin`` + ``meta.yml`` + ``patch_ids.bin``, byte-compatible
with the JAX package's: a cache written by either package opens in the
other) and :meth:`Catalog.load_block`, the data unit of the blocked
measurement path, are ported as well. The multi-process cache writer of the
JAX package is not: :meth:`Catalog.to_cache` runs in one process.
"""

from __future__ import annotations

import logging
from collections.abc import Mapping
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.coordinates import (
    AngularCoordinates,
    AngularDistances,
    radec_to_xyz,
)
from yet_another_wizz_tpu_torch.datachunk import DataChunk, check_patch_ids
from yet_another_wizz_tpu_torch.catalog.patch import (
    Metadata,
    read_patch_data,
    write_patch_data,
)
from yet_another_wizz_tpu_torch.ops.kmeans import assign_patches, kmeans_patch_centers
from yet_another_wizz_tpu_torch.ops.tiles import DEFAULT_TILE_SIZE, build_tile_set
from yet_another_wizz_tpu_torch.options import Closed
from yet_another_wizz_tpu_torch.utils.tracing import count

if TYPE_CHECKING:
    from collections.abc import Iterator

    import torch
    from numpy.typing import ArrayLike, NDArray
    from typing_extensions import Self

    from yet_another_wizz_tpu_torch.binning import Binning
    from yet_another_wizz_tpu_torch.ops.tiles import TileSet

__all__ = [
    "BlockData",
    "Catalog",
    "InconsistentPatchesError",
    "MemoryPatch",
]

logger = logging.getLogger(__name__)

PATCH_NAME_TEMPLATE = "patch_{:}"
DEFAULT_PROBE_SIZE = 500_000


class InconsistentPatchesError(Exception):
    """Patch centers or ids of two catalogs do not match."""


def prepare_cache_directory(cache: Path, overwrite: bool) -> None:
    """Create an empty cache directory (shared by every cache writer): an
    existing non-empty directory raises unless ``overwrite``, which clears
    it."""
    if cache.exists():
        if not overwrite and any(cache.iterdir()):
            raise FileExistsError(f"cache directory not empty: {cache}")
        if overwrite:
            import shutil

            shutil.rmtree(cache)
    cache.mkdir(parents=True, exist_ok=True)


def write_patch_ids_file(cache_directory: Path, num_patches: int) -> None:
    """Write the reference's ``patch_ids.bin`` (sorted int16 ids, raw
    tofile; yaw/catalog/catalog.py:529-530) so caches written here reopen in
    the reference package, whose open path requires the file."""
    from yet_another_wizz_tpu_torch.datachunk import PATCH_ID_DTYPE

    np.arange(num_patches, dtype=PATCH_ID_DTYPE).tofile(
        Path(cache_directory) / "patch_ids.bin"
    )


def discover_patch_dirs(
    cache_directory: Path, *, require_contiguous: bool = False
) -> list[Path]:
    """The ``patch_{i}`` directories of a cache, sorted by patch id.
    Shared by the resident and the lazy catalog open paths so the cache
    naming scheme lives in one place."""
    if not cache_directory.exists():
        raise FileNotFoundError(f"no cache found: {cache_directory}")
    patch_dirs = sorted(
        (
            p
            for p in cache_directory.glob(PATCH_NAME_TEMPLATE.format("*"))
            # only patch DIRECTORIES: the top-level patch_ids.bin file
            # matches the glob too
            if p.is_dir()
        ),
        key=lambda p: int(p.name.split("_")[1]),
    )
    if not patch_dirs:
        raise FileNotFoundError(f"cache is empty: {cache_directory}")
    if require_contiguous:
        expected = [
            cache_directory / PATCH_NAME_TEMPLATE.format(pid)
            for pid in range(len(patch_dirs))
        ]
        if patch_dirs != expected:
            raise ValueError(
                f"cache has non-contiguous patch ids: {cache_directory}"
            )
    return patch_dirs


class BlockData:
    """Columns of one contiguous patch block (patch ids rebased to the
    block): the data unit the blocked measurement path keeps resident."""

    __slots__ = ("xyz", "patch_ids", "weights", "redshifts", "kappa")

    def __init__(self, *, xyz, patch_ids, weights, redshifts, kappa):
        self.xyz = xyz
        self.patch_ids = patch_ids
        self.weights = weights
        self.redshifts = redshifts
        self.kappa = kappa


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

    Create instances with :meth:`from_arrays`, :meth:`from_file`,
    :meth:`from_dataframe` or :meth:`from_random`; ``Catalog(cache_directory)``
    reopens a cache written by :meth:`to_cache` (or by the JAX package).
    Iterating/indexing yields per-patch views.
    """

    __slots__ = (
        "cache_directory",
        "_chunk",
        "_xyz",
        "_patch_ids",
        "patch_centers_xyz",
        "patch_radii",
        "num_patches",
        "_tile_cache",
        "_bin_sums_cache",
        "__weakref__",  # the blocked path's tile caches key catalogs weakly
    )

    def __init__(self, cache_directory: Path | str) -> None:
        self.cache_directory = Path(cache_directory)
        logger.info("restoring from cache directory: %s", cache_directory)
        # contiguity is load-bearing: a gapped cache would produce patch
        # ids >= num_patches and an out-of-bounds write in the native
        # geometry kernel
        patch_dirs = discover_patch_dirs(
            self.cache_directory, require_contiguous=True
        )

        # numpy file reads release the GIL, so a thread pool overlaps the
        # per-patch disk reads
        from concurrent.futures import ThreadPoolExecutor

        from yet_another_wizz_tpu_torch.utils.misc import host_thread_count

        def load(path):
            _, data = read_patch_data(path / "data.bin")
            return data

        max_workers = min(host_thread_count(16), len(patch_dirs))
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            chunks = list(pool.map(load, patch_dirs))

        self._chunk = np.concatenate(chunks)
        self._patch_ids = np.repeat(
            np.arange(len(chunks), dtype=np.int32), [len(c) for c in chunks]
        )
        self.num_patches = len(patch_dirs)
        self._xyz = radec_to_xyz(self._chunk["ra"], self._chunk["dec"])
        # the meta.yml files record the centers the points were ASSIGNED
        # with (possibly applied externally); trust them like the
        # reference does instead of recomputing drifted means
        stored = self._centers_from_metadata(patch_dirs)
        self._init_patch_geometry(centers_xyz=stored)
        self._tile_cache = {}

    @staticmethod
    def _centers_from_metadata(patch_dirs) -> NDArray | None:
        """Stored patch centers from the cache's meta.yml files, or None
        when any is missing (partial caches recompute)."""
        centers = []
        for path in patch_dirs:
            meta_file = path / "meta.yml"
            if not meta_file.exists():
                return None
            centers.append(Metadata.from_file(meta_file).center.to_3d())
        return np.concatenate(centers)

    @classmethod
    def _from_streamed(
        cls: type[Self],
        chunk: NDArray,
        patch_ids: NDArray,
        num_patches: int,
        cache_directory: Path | str | None,
        centers_xyz: NDArray | None = None,
    ) -> Self:
        """Construct directly from streaming-ingestion output (patch-major
        rows with known assignment), skipping the cache read-back."""
        check_patch_ids(num_patches - 1)  # int16 bound (<= 32767)
        new = cls.__new__(cls)
        new.cache_directory = (
            Path(cache_directory) if cache_directory is not None else None
        )
        new._chunk = chunk
        new._patch_ids = np.asarray(patch_ids, dtype=np.int32)
        new.num_patches = num_patches
        new._xyz = radec_to_xyz(chunk["ra"], chunk["dec"])
        new._init_patch_geometry(centers_xyz=centers_xyz)
        new._tile_cache = {}
        return new

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
        cache_directory: Path | str | None = None,
        overwrite: bool = False,
        device: torch.device | str = "cuda",
        **_ignored,
    ) -> Self:
        """Create a catalog from per-column arrays (the primary in-memory
        constructor; all other constructors funnel through it). Catalogs
        large enough for the device patch assignment
        (:data:`~yet_another_wizz_tpu_torch.ops.kmeans.
        DEVICE_ASSIGN_THRESHOLD`) run it on ``device``, which raises when it
        is a CUDA device and CUDA is not available. With
        ``cache_directory`` the catalog is also written there
        (:meth:`to_cache`)."""
        chunk = DataChunk.create(
            ra, dec,
            weights=weights, redshifts=redshifts, kappa=kappa,
            degrees=degrees,
        )
        new = cls.__new__(cls)
        new._chunk = chunk
        new._xyz = radec_to_xyz(chunk["ra"], chunk["dec"])
        new._tile_cache = {}
        new.cache_directory = None

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

        if cache_directory is not None:
            new.to_cache(cache_directory, overwrite=overwrite)
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

    def to_cache(
        self, cache_directory: Path | str, *, overwrite: bool = False
    ) -> None:
        """Write the catalog to a reference-compatible patch cache.

        Root-only in multi-process jobs (every process holds the same
        in-memory catalog): the outcome broadcast of
        :func:`~yet_another_wizz_tpu_torch.parallel.distributed.run_on_root`
        makes the cache visible to all processes through the shared file
        system and raises a root-side error on every process."""
        from yet_another_wizz_tpu_torch.parallel.distributed import run_on_root

        cache = Path(cache_directory)

        def write_on_root() -> None:
            prepare_cache_directory(cache, overwrite)
            logger.info(
                "writing %d patches to cache: %s", self.num_patches, cache
            )
            # one stable sort + boundary search instead of a full-array
            # boolean mask per patch
            order = np.argsort(self._patch_ids, kind="stable")
            sorted_chunk = self._chunk[order]
            bounds = np.searchsorted(
                self._patch_ids[order], np.arange(self.num_patches + 1)
            )
            for pid in range(self.num_patches):
                rows = sorted_chunk[bounds[pid] : bounds[pid + 1]]
                patch_dir = cache / PATCH_NAME_TEMPLATE.format(pid)
                patch_dir.mkdir()
                write_patch_data(patch_dir / "data.bin", rows)
                # record the catalog's own (possibly applied) patch center
                # so reopening the cache preserves it
                meta = Metadata.compute(
                    DataChunk.get_coords(rows),
                    weights=DataChunk.getattr(rows, "weights"),
                    center=AngularCoordinates.from_3d(
                        self.patch_centers_xyz[pid : pid + 1]
                    ),
                )
                meta.to_file(patch_dir / "meta.yml")
            write_patch_ids_file(cache, self.num_patches)

        run_on_root(write_on_root)
        self.cache_directory = cache

    @classmethod
    def from_dataframe(
        cls: type[Self],
        cache_directory: Path | str | None,
        dataframe,
        *,
        ra_name: str,
        dec_name: str,
        weight_name: str | None = None,
        redshift_name: str | None = None,
        kappa_name: str | None = None,
        patch_centers=None,
        patch_name: str | None = None,
        patch_num: int | None = None,
        degrees: bool = True,
        overwrite: bool = False,
        probe_size: int = DEFAULT_PROBE_SIZE,
        device: torch.device | str = "cuda",
        **_ignored,
    ) -> Self:
        """Create a catalog from a pandas-like dataframe. ``device`` (which
        raises when it is a CUDA device and CUDA is not available) runs the
        patch assignment as in :meth:`from_arrays`."""
        from yet_another_wizz_tpu_torch.ops.paircount import resolve_device

        device = resolve_device(device)

        def column(name):
            return np.asarray(dataframe[name]) if name is not None else None

        return cls.from_arrays(
            column(ra_name),
            column(dec_name),
            weights=column(weight_name),
            redshifts=column(redshift_name),
            kappa=column(kappa_name),
            degrees=degrees,
            patch_centers=patch_centers,
            patch_ids=column(patch_name),
            patch_num=patch_num,
            probe_size=probe_size,
            cache_directory=cache_directory,
            overwrite=overwrite,
            device=device,
        )

    @classmethod
    def from_file(
        cls: type[Self],
        cache_directory: Path | str | None,
        path: Path | str,
        *,
        ra_name: str,
        dec_name: str,
        weight_name: str | None = None,
        redshift_name: str | None = None,
        kappa_name: str | None = None,
        patch_centers=None,
        patch_name: str | None = None,
        patch_num: int | None = None,
        degrees: bool = True,
        overwrite: bool = False,
        probe_size: int = DEFAULT_PROBE_SIZE,
        chunksize: int | None = None,
        streaming: bool | None = None,
        progress: bool = False,
        max_workers: int | None = None,
        device: torch.device | str = "cuda",
        **_ignored,
    ) -> Self:
        """Create a catalog from a FITS / HDF5 / Parquet / CSV file
        (:mod:`~yet_another_wizz_tpu_torch.catalog.readers`; the HDF5,
        Parquet and CSV readers need ``h5py``, ``pyarrow`` and ``pandas``).

        Inputs larger than one chunk are streamed through patch assignment
        into the disk cache with bounded memory (``streaming`` forces or
        disables this; it requires a ``cache_directory``). In a
        multi-process job streaming ingestion is collective: the root
        resolves the patch centers and reads, every process writes the
        patches it owns into the shared cache
        (:func:`~yet_another_wizz_tpu_torch.catalog.ingest.
        write_patches_collective`). ``max_workers``
        bounds the host worker pools of the ingestion. ``device`` (which
        raises when it is a CUDA device and CUDA is not available) runs the
        patch assignment as in :meth:`from_arrays`.
        """
        from yet_another_wizz_tpu_torch.catalog.readers import new_filereader
        from yet_another_wizz_tpu_torch.ops.paircount import resolve_device
        from yet_another_wizz_tpu_torch.utils.misc import thread_limit

        device = resolve_device(device)
        logger.info("reading catalog file: %s", path)
        with thread_limit(max_workers):
            with new_filereader(
                path, ra_name=ra_name, dec_name=dec_name,
                weight_name=weight_name, redshift_name=redshift_name,
                kappa_name=kappa_name, patch_name=patch_name,
                degrees=degrees, chunksize=chunksize,
            ) as reader:
                if streaming is None:
                    streaming = (
                        cache_directory is not None and reader.num_chunks > 1
                    )
                if streaming:
                    from yet_another_wizz_tpu_torch.catalog.ingest import (
                        resolve_patch_centers,
                        write_patches_collective,
                        write_patches_streaming,
                    )
                    from yet_another_wizz_tpu_torch.parallel.distributed import (
                        num_processes,
                        run_on_root,
                    )

                    if cache_directory is None and num_processes() > 1:
                        raise ValueError(
                            "multi-process streaming ingestion requires a "
                            "'cache_directory' (the processes share it)"
                        )
                    # patch-source priority matches the in-memory path
                    # (_resolve_patch_assignment): explicit centers beat a
                    # patch-id column beat kmeans; the root resolves them
                    # once and every process receives the same centers
                    centers = None
                    if patch_centers is not None or patch_name is None:
                        centers = run_on_root(
                            resolve_patch_centers,
                            reader,
                            patch_centers=patch_centers,
                            patch_num=patch_num,
                            probe_size=probe_size,
                            device=device,
                        )
                        if centers is None:
                            raise ValueError(
                                "exactly one of 'patch_centers', 'patch_name', "
                                "or 'patch_num' is required"
                            )
                    if num_processes() > 1:
                        write_patches_collective(
                            reader, cache_directory, centers,
                            overwrite=overwrite, progress=progress,
                            device=device,
                        )
                        return cls(cache_directory)
                    # stream through patch assignment, keeping the assembled
                    # data so the catalog is constructed directly (no cache
                    # read-back)
                    num_patches, (chunk, patch_ids) = write_patches_streaming(
                        reader, cache_directory, centers, overwrite=overwrite,
                        progress=progress, keep_data=True, device=device,
                    )
                    return cls._from_streamed(
                        chunk, patch_ids, num_patches, cache_directory,
                        centers_xyz=centers,
                    )

                chunks = [chunk for chunk in reader]
            data = np.concatenate(chunks)

            return cls.from_arrays(
                data["ra"],
                data["dec"],
                weights=DataChunk.getattr(data, "weights"),
                redshifts=DataChunk.getattr(data, "redshifts"),
                kappa=DataChunk.getattr(data, "kappa"),
                degrees=False,  # readers convert to radian
                patch_centers=patch_centers,
                patch_ids=DataChunk.getattr(data, "patch_ids"),
                patch_num=patch_num,
                probe_size=probe_size,
                cache_directory=cache_directory,
                overwrite=overwrite,
                device=device,
            )

    @classmethod
    def from_random(
        cls: type[Self],
        cache_directory: Path | str | None,
        generator,
        num_randoms: int,
        *,
        patch_centers=None,
        patch_num: int | None = None,
        overwrite: bool = False,
        probe_size: int = DEFAULT_PROBE_SIZE,
        device: torch.device | str = "cuda",
        **_ignored,
    ) -> Self:
        """Create a catalog by sampling a random point generator
        (:mod:`~yet_another_wizz_tpu_torch.randoms`). ``device`` (which
        raises when it is a CUDA device and CUDA is not available) runs the
        patch assignment as in :meth:`from_arrays`."""
        from yet_another_wizz_tpu_torch.ops.paircount import resolve_device

        device = resolve_device(device)
        chunk = generator(num_randoms)
        return cls.from_arrays(
            chunk["ra"],
            chunk["dec"],
            weights=DataChunk.getattr(chunk, "weights"),
            redshifts=DataChunk.getattr(chunk, "redshifts"),
            degrees=False,
            patch_centers=patch_centers,
            patch_num=patch_num,
            probe_size=probe_size,
            cache_directory=cache_directory,
            overwrite=overwrite,
            device=device,
        )

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

    def load_block(self, patch_lo: int, patch_hi: int) -> BlockData:
        """Columns of the patches in ``[patch_lo, patch_hi)`` with patch
        ids rebased to the block: the unit of residency of the blocked
        (out-of-core) measurement path."""
        select = (self._patch_ids >= patch_lo) & (self._patch_ids < patch_hi)

        def sub(col):
            return None if col is None else col[select]

        return BlockData(
            xyz=self._xyz[select],
            patch_ids=self._patch_ids[select] - patch_lo,
            weights=sub(self.weights),
            redshifts=sub(self.redshifts),
            kappa=sub(self.kappa),
        )

    def get_centers(self) -> AngularCoordinates:
        """Patch cap centers."""
        return AngularCoordinates.from_3d(self.patch_centers_xyz)

    def get_radii(self) -> AngularDistances:
        """Patch cap radii."""
        return AngularDistances(self.patch_radii)

    # -- device tiles (the kd-tree replacement) -----------------------------

    def build_trees(
        self,
        binning: ArrayLike | None,
        *,
        closed: Closed | str = Closed.right,
        leafsize: int = DEFAULT_TILE_SIZE,
        force: bool = False,
        progress: bool = False,
        max_workers: int | None = None,
        max_angle: float | None = None,
        device: torch.device | str = "cuda",
    ) -> None:
        """Pre-build the tiles for a given redshift binning (API-compatible
        with the reference's kd-tree building entry point; ``leafsize`` maps
        onto the tile size).

        Binned tile sets are built in the ``zmajor`` layout, the one
        equal-bin counting (autocorrelations, binned data-random counts)
        always requests. Pass ``max_angle`` (the maximum angular scale of
        the upcoming measurement, in radians) to also build the layout a
        binned-rows/unbinned-columns cross-correlation will pick for this
        catalog; without it that choice cannot be made here and the
        measurement may build one more tile set on demand. ``force`` drops
        the cached tile sets first. ``progress`` and ``max_workers`` are
        accepted for the reference's signature; the build runs in the
        calling thread.

        On a CUDA ``device`` (the default, which raises when CUDA is not
        available) each built tile set's lanes are also uploaded, and the
        chunk caps the cumulative kernels read are derived from them, so
        that a following single-device measurement on that card finds
        them in place. The threshold tables and the direct mode's entry
        layout belong to a measurement's configuration, not to a catalog,
        and are built by the measurement. With ``device="cpu"`` only the
        host tiles are built.
        """
        from yet_another_wizz_tpu_torch.binning import Binning
        from yet_another_wizz_tpu_torch.ops.paircount import resolve_device
        from yet_another_wizz_tpu_torch.ops.tiles import preferred_tile_layout

        device = resolve_device(device)
        binning = None if binning is None else Binning(binning, closed=closed)
        if force:
            self._tile_cache.clear()
        layouts = {"spatial"} if binning is None else {"zmajor"}
        if binning is not None and max_angle is not None:
            layouts.add(
                preferred_tile_layout(
                    self, len(binning), max_angle,
                    equal_bin_counting=False, tile_size=leafsize,
                )
            )
        tile_sets = [
            self.get_tiles(binning, tile_size=leafsize, layout=layout)
            for layout in sorted(layouts)
        ]
        if device.type == "cuda":
            from yet_another_wizz_tpu_torch.ops.cuda_paircount import (
                prepare_lanes,
            )

            for tiles in tile_sets:
                prepare_lanes(tiles, device)

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

        Each call counts a hit or a miss of the cache (``cache.hit.tiles``,
        ``cache.miss.tiles``).
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
            count("cache.hit.tiles")
            return self._tile_cache[key]
        count("cache.miss.tiles")

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
