"""Bounded-memory streaming ingestion of large catalogs.

Ported from the JAX package's ``catalog/ingest.py`` (the reference's
ingestion pipeline, yaw/catalog/catalog.py:587-908): file chunks are
streamed through patch assignment into per-patch cache writers, so the peak
memory footprint is one chunk (default 16.7M rows) regardless of catalog
size. The chunks are read ahead on a thread and written by another while
the next chunk is assigned to its patches (on ``device`` for large chunks,
see :func:`~yet_another_wizz_tpu_torch.ops.kmeans.assign_patches`).

Used by :meth:`Catalog.from_file` when ``streaming=True`` (automatic for
inputs larger than one chunk). The multi-process writer
(:func:`write_patches_collective`) comes with the port of the JAX package's
``parallel`` layer.
"""

from __future__ import annotations

import logging
import queue
import threading
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.catalog.patch import Metadata, PatchWriter
from yet_another_wizz_tpu_torch.coordinates import AngularCoordinates, radec_to_xyz
from yet_another_wizz_tpu_torch.datachunk import DataChunk
from yet_another_wizz_tpu_torch.ops.kmeans import assign_patches, kmeans_patch_centers

if TYPE_CHECKING:
    import torch
    from numpy.typing import NDArray

    from yet_another_wizz_tpu_torch.catalog.readers import BaseReader

__all__ = [
    "resolve_patch_centers",
    "write_patches_collective",
    "write_patches_streaming",
]

logger = logging.getLogger(__name__)


def _applied_center(centers_xyz, pid: int):
    """The center that assigned patch ``pid`` as AngularCoordinates, or
    None (patch-id-column mode) to fall back to the weighted mean —
    recorded in meta.yml so caches preserve the applied centers like the
    reference (yaw/catalog/patch.py:104-146)."""
    if centers_xyz is None:
        return None
    return AngularCoordinates.from_3d(
        np.asarray(centers_xyz, dtype=np.float64)[pid : pid + 1]
    )


def _chunk_patch_ids(chunk, centers_xyz, device):
    """Patch ids for one streamed chunk, with the same source priority as
    the in-memory path (_resolve_patch_assignment): explicit centers beat
    a patch-id column carried by the file. Returns the chunk (patch-id
    column removed if present) and the ids."""
    column_ids = DataChunk.getattr(chunk, "patch_ids")
    if column_ids is not None:
        chunk, _ = DataChunk.pop(chunk, "patch_ids")
    if centers_xyz is not None:
        xyz = radec_to_xyz(chunk["ra"], chunk["dec"])
        return chunk, assign_patches(xyz, centers_xyz, device=device)
    if column_ids is None:
        raise ValueError("chunk provides no patch ids and no centers are set")
    return chunk, column_ids


def _split_by_patch(chunk, patch_ids):
    """Sort a chunk by patch id and split it into per-patch parts.

    Negative ids are rejected: the caches and the count tensors require
    contiguous ids ``0..P-1``, and a file using ``-1`` as an "unassigned"
    sentinel would otherwise write a ``patch_-1`` cache directory.

    Returns ``(splits, sorted_ids)`` where ``splits`` is a list of
    ``(patch_id, rows)`` pairs."""
    if len(patch_ids) and int(np.min(patch_ids)) < 0:
        raise ValueError(
            "'patch_ids' must be non-negative (contiguous 0..P-1; "
            "drop or reassign sentinel ids before ingestion)"
        )
    order = np.argsort(patch_ids, kind="stable")
    sorted_ids = patch_ids[order]
    sorted_chunk = chunk[order]
    unique, first = np.unique(sorted_ids, return_index=True)
    splits = [
        (int(pid), part)
        for pid, part in zip(unique, np.split(sorted_chunk, first[1:]))
    ]
    return splits, sorted_ids


def resolve_patch_centers(
    reader: BaseReader,
    *,
    patch_centers=None,
    patch_num: int | None = None,
    probe_size: int = 500_000,
    device: torch.device | str = "cuda",
) -> NDArray | None:
    """Patch centers as unit vectors: use the given ones, or generate them
    with kmeans on a sparse probe of the input (None when the input
    provides its own patch-id column). ``device`` runs the kmeans
    assignment as in :func:`~yet_another_wizz_tpu_torch.ops.kmeans.
    kmeans_patch_centers`."""
    if patch_centers is not None:
        from yet_another_wizz_tpu_torch.catalog.catalog import Catalog

        if isinstance(patch_centers, Catalog):
            return patch_centers.get_centers().to_3d()
        if isinstance(patch_centers, AngularCoordinates):
            return patch_centers.to_3d()
        centers = np.asarray(patch_centers, dtype=np.float64)
        # same validation as the in-memory path: a malformed array would
        # mis-stride the native assignment kernel silently
        if centers.ndim != 2 or centers.shape[1] not in (2, 3):
            raise ValueError(
                "'patch_centers' must be AngularCoordinates, a Catalog, "
                "or an array of shape (P, 2) radian / (P, 3) unit vectors"
            )
        if centers.shape[1] == 2:
            return radec_to_xyz(centers[:, 0], centers[:, 1])
        return centers

    if patch_num is None:
        return None

    logger.info(
        "computing %d patch centers from a %d-row probe",
        patch_num,
        min(probe_size, reader.num_records),
    )
    probe = reader.get_probe(probe_size)
    xyz = radec_to_xyz(probe["ra"], probe["dec"])
    weights = DataChunk.getattr(probe, "weights")
    return kmeans_patch_centers(xyz, patch_num, weights=weights, device=device)


def write_patches_streaming(
    reader: BaseReader,
    cache_directory: Path | str | None,
    centers_xyz: NDArray | None,
    *,
    overwrite: bool = False,
    progress: bool = False,
    device: torch.device | str = "cuda",
) -> tuple[int, tuple[NDArray, NDArray]]:
    """Stream a chunked reader through patch assignment.

    Per chunk: assign patch ids (against the centers on ``device``, unless
    the chunk carries a patch-id column) and split the chunk by patch. With
    a ``cache_directory`` the splits are appended to buffered per-patch
    writers on disk; they are also assembled in memory (patch-major,
    chunk-arrival order within each patch — byte identical to reading the
    cache back) so the caller can construct the catalog directly without
    the cache round trip.

    Returns ``(num_patches, (chunk, patch_ids))``.
    """
    cache = None
    if cache_directory is not None:
        from yet_another_wizz_tpu_torch.catalog.catalog import (
            prepare_cache_directory,
        )

        cache = Path(cache_directory)
        prepare_cache_directory(cache, overwrite)

    from yet_another_wizz_tpu_torch.catalog.catalog import PATCH_NAME_TEMPLATE
    from yet_another_wizz_tpu_torch.catalog.readers import prefetch_chunks

    writers: dict[int, PatchWriter] = {}
    parts: dict[int, list[NDArray]] = {}
    chunk_iter = prefetch_chunks(reader)
    if progress:
        from yet_another_wizz_tpu_torch.utils.logging import Indicator

        chunk_iter = Indicator(chunk_iter, reader.num_chunks)

    num_expected = 0 if centers_xyz is None else len(centers_xyz)

    # producer/writer overlap: reading + patch assignment of the next chunk
    # proceeds while the previous chunk's patch splits are written
    work: queue.Queue = queue.Queue(maxsize=2)
    writer_error: list[BaseException] = []

    def writer_task() -> None:
        while True:
            item = work.get()
            if item is None:
                return
            try:
                info, splits = item
                for pid, part in splits:
                    parts.setdefault(pid, []).append(part)
                    if cache is None:
                        continue
                    if pid not in writers:
                        writers[pid] = PatchWriter(
                            cache / PATCH_NAME_TEMPLATE.format(pid), info
                        )
                    writers[pid].process_chunk(part)
            except BaseException as err:  # propagated to the producer
                writer_error.append(err)
                return
            finally:
                work.task_done()

    writer = threading.Thread(target=writer_task, daemon=True)
    writer.start()

    try:
        for chunk in chunk_iter:
            chunk, patch_ids = _chunk_patch_ids(chunk, centers_xyz, device)
            splits, sorted_ids = _split_by_patch(chunk, patch_ids)
            if writer_error:
                raise writer_error[0]
            work.put((DataChunk.get_info(chunk), splits))
            if len(sorted_ids):
                num_expected = max(num_expected, int(sorted_ids[-1]) + 1)
    finally:
        # the writer thread may already be dead (error) with the queue
        # full; a blocking put would then hang forever and swallow the real
        # failure. Only drain pending items once the writer stopped
        # consuming — on the success path they are real chunks it still
        # has to process.
        while True:
            try:
                work.put(None, timeout=0.1)
                break
            except queue.Full:
                if writer_error or not writer.is_alive():
                    try:
                        work.get_nowait()
                    except queue.Empty:
                        pass
        writer.join()
    if writer_error:
        raise writer_error[0]

    missing = [pid for pid in range(num_expected) if pid not in parts]
    if missing:
        raise ValueError(f"patches with no data: {missing}")
    num_patches = len(parts)

    # patch-major assembly in writer-append order: byte-identical to
    # reading the finalized cache back
    patch_arrays = [
        np.concatenate(parts[pid]) if len(parts[pid]) > 1 else parts[pid][0]
        for pid in range(num_patches)
    ]
    patch_ids = np.repeat(
        np.arange(num_patches, dtype=np.int32),
        [len(arr) for arr in patch_arrays],
    )

    for pid, patch_writer in writers.items():
        patch_writer.finalize()
        # compute and store metadata now so reopening the cache is cheap
        data = patch_arrays[pid]
        meta = Metadata.compute(
            DataChunk.get_coords(data),
            weights=DataChunk.getattr(data, "weights"),
            center=_applied_center(centers_xyz, pid),
        )
        meta.to_file(patch_writer.cache_path / "meta.yml")

    if cache is not None:
        from yet_another_wizz_tpu_torch.catalog.catalog import (
            write_patch_ids_file,
        )

        write_patch_ids_file(cache, num_patches)

    logger.info(
        "streamed %d patches (%s records)%s",
        num_patches,
        reader.num_records,
        " to cache" if cache is not None else " in memory",
    )
    return num_patches, (np.concatenate(patch_arrays), patch_ids)


def write_patches_collective(*args, **kwargs) -> int:
    """Multi-process streaming ingestion over several hosts: comes with the
    port of the JAX package's ``parallel`` layer (``torch.distributed``)."""
    raise NotImplementedError(
        "multi-process ingestion is not ported yet; ingest in one process"
    )
