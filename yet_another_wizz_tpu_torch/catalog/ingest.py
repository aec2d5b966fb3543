"""Bounded-memory streaming ingestion of large catalogs.

Ported from the JAX package's ``catalog/ingest.py`` (the reference's
ingestion pipeline, yaw/catalog/catalog.py:587-908): file chunks are
streamed through patch assignment into per-patch cache writers, so the peak
memory footprint is one chunk (default 16.7M rows) regardless of catalog
size. The chunks are read ahead on a thread and written by another while
the next chunk is assigned to its patches (on ``device`` for large chunks,
see :func:`~yet_another_wizz_tpu_torch.ops.kmeans.assign_patches`).

Used by :meth:`Catalog.from_file` when ``streaming=True`` (automatic for
inputs larger than one chunk), which keeps the assembled rows
(``keep_data=True``); in a multi-process job through
:func:`write_patches_collective`, where the root reads and every process
writes the patches it owns. Called with ``keep_data=False``,
:func:`write_patches_streaming` ingests any reader (a file, a dataframe, a
random generator) into a cache larger than memory.
"""

from __future__ import annotations

import logging
import queue
import threading
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.catalog.patch import (
    DEFAULT_BUFFERSIZE,
    Metadata,
    PatchWriter,
    read_patch_data,
)
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

COLLECTIVE_BROADCAST_ROWS = 1_048_576
"""Row cap per broadcast round of :func:`write_patches_collective` (~40 MB
of columns): every round's pickled patch splits are held by every
process."""


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
    buffersize: int | None = None,
    progress: bool = False,
    keep_data: bool = False,
    device: torch.device | str = "cuda",
) -> tuple[int, tuple[NDArray, NDArray] | None]:
    """Stream a chunked reader through patch assignment.

    Per chunk: assign patch ids (against the centers on ``device``, unless
    the chunk carries a patch-id column) and split the chunk by patch. With
    a ``cache_directory`` the splits are appended to per-patch writers on
    disk, each buffering ``buffersize`` rows (default
    :data:`~yet_another_wizz_tpu_torch.catalog.patch.DEFAULT_BUFFERSIZE`);
    without ``keep_data`` nothing of the catalog is kept beyond the chunks
    in flight and the writers' buffers, and each patch's metadata is
    computed from its file. With ``keep_data`` the splits are also
    assembled in memory (patch-major, chunk-arrival order within each patch
    — byte identical to reading the cache back) so the caller can construct
    the catalog directly without the cache round trip;
    ``cache_directory=None`` requires ``keep_data`` and skips the disk.

    Returns ``(num_patches, assembled)`` where ``assembled`` is None or a
    ``(chunk, patch_ids)`` pair.
    """
    if cache_directory is None and not keep_data:
        raise ValueError("either a cache_directory or keep_data is required")
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

    buffersize = DEFAULT_BUFFERSIZE if buffersize is None else buffersize
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
                    if keep_data:
                        parts.setdefault(pid, []).append(part)
                    if cache is None:
                        continue
                    if pid not in writers:
                        writers[pid] = PatchWriter(
                            cache / PATCH_NAME_TEMPLATE.format(pid), info,
                            buffersize,
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
            # hold no rows while the next chunk is read: the writer has them
            del chunk, patch_ids, splits, sorted_ids
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

    seen = parts if keep_data else writers
    missing = [pid for pid in range(num_expected) if pid not in seen]
    if missing:
        raise ValueError(f"patches with no data: {missing}")
    num_patches = len(seen)

    assembled = None
    if keep_data:
        # patch-major assembly in writer-append order: byte-identical to
        # reading the finalized cache back
        patch_arrays = [
            np.concatenate(parts[pid]) if len(parts[pid]) > 1 else parts[pid][0]
            for pid in range(num_patches)
        ]
        parts.clear()
        patch_ids = np.repeat(
            np.arange(num_patches, dtype=np.int32),
            [len(arr) for arr in patch_arrays],
        )
        assembled = (np.concatenate(patch_arrays), patch_ids)

    for pid, patch_writer in writers.items():
        patch_writer.finalize()
        # compute and store metadata now so reopening the cache is cheap
        # (from the in-memory patch data when it is kept, else from the
        # patch's file, one patch at a time)
        if keep_data:
            data = patch_arrays[pid]
        else:
            _, data = read_patch_data(patch_writer.data_path)
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
    return num_patches, assembled


def write_patches_collective(
    reader: BaseReader,
    cache_directory: Path | str,
    centers_xyz: NDArray | None,
    *,
    overwrite: bool = False,
    progress: bool = False,
    buffersize: int | None = None,
    device: torch.device | str = "cuda",
) -> int:
    """Multi-process streaming ingestion (the JAX package's
    ``write_patches_collective``).

    The root process streams the reader through patch assignment (on
    ``device``) and broadcasts each chunk's patch splits; every process
    writes only the patches it owns (``pid % num_processes``), so buffered
    cache writing, metadata computation and file I/O run in parallel, the
    analogue of the reference's reader/writer rank split
    (yaw/catalog/catalog.py:587-908). All processes must share the cache
    file system. ``buffersize`` sets the rows each patch writer buffers, as
    in :func:`write_patches_streaming`. The cache equals, byte for byte, the
    single-process streaming ingest's.

    Errors: a root-side reader error is broadcast in the stream and raised
    everywhere; a writer error on any process is kept until the final
    status exchange (the process keeps draining the stream so the
    collectives stay in step), then raised on every process.

    Returns the number of patches.
    """
    from yet_another_wizz_tpu_torch.catalog.catalog import (
        PATCH_NAME_TEMPLATE,
        prepare_cache_directory,
        write_patch_ids_file,
    )
    from yet_another_wizz_tpu_torch.catalog.readers import prefetch_chunks
    from yet_another_wizz_tpu_torch.parallel import distributed as dist

    num_procs = dist.num_processes()
    rank = dist.process_index()
    cache = Path(cache_directory)
    dist.run_on_root(prepare_cache_directory, cache, overwrite)

    writers: dict[int, PatchWriter] = {}
    buffersize = DEFAULT_BUFFERSIZE if buffersize is None else buffersize
    local_error: BaseException | None = None
    num_patches = 0

    def write_owned(info, splits) -> None:
        nonlocal local_error
        if local_error is not None:
            return  # stay in step, but stop touching the file system
        try:
            for pid, part in splits:
                if pid % num_procs != rank:
                    continue
                if pid not in writers:
                    writers[pid] = PatchWriter(
                        cache / PATCH_NAME_TEMPLATE.format(pid), info, buffersize
                    )
                writers[pid].process_chunk(part)
        except Exception as err:
            local_error = err

    def bounded(chunks):
        for chunk in chunks:
            for lo in range(0, len(chunk), COLLECTIVE_BROADCAST_ROWS):
                yield chunk[lo : lo + COLLECTIVE_BROADCAST_ROWS]

    if dist.on_root():
        num_expected = 0 if centers_xyz is None else len(centers_xyz)
        seen: set[int] = set()
        chunk_iter = bounded(prefetch_chunks(reader))
        if progress:
            from yet_another_wizz_tpu_torch.utils.logging import Indicator

            # full chunks plus the (shorter) last one, in bounded rounds
            rounds = -(-reader.chunksize // COLLECTIVE_BROADCAST_ROWS)
            full = max(0, reader.num_chunks - 1)
            last = reader.num_records - full * reader.chunksize
            total = full * rounds + max(1, -(-last // COLLECTIVE_BROADCAST_ROWS))
            chunk_iter = Indicator(chunk_iter, total)
        root_error: BaseException | None = None
        try:
            for chunk in chunk_iter:
                chunk, patch_ids = _chunk_patch_ids(chunk, centers_xyz, device)
                splits, sorted_ids = _split_by_patch(chunk, patch_ids)
                seen.update(pid for pid, _ in splits)
                if len(sorted_ids):
                    num_expected = max(num_expected, int(sorted_ids[-1]) + 1)
                info = DataChunk.get_info(chunk)
                dist.broadcast(("chunk", info, splits))
                write_owned(info, splits)
            missing = sorted(set(range(num_expected)) - seen)
            if missing:
                raise ValueError(f"patches with no data: {missing}")
        except Exception as err:
            root_error = err
        if root_error is not None:
            # every process raises and skips the status exchange: the
            # stream is the last collective then
            dist.broadcast(("error", dist.picklable_exception(root_error)))
            raise root_error
        dist.broadcast(("done", num_expected))
        num_patches = num_expected
    else:
        while True:
            message = dist.broadcast(None)
            if message[0] == "chunk":
                write_owned(*message[1:])
            elif message[0] == "done":
                num_patches = message[1]
                break
            else:  # the root failed mid-stream; all processes raise
                raise message[1]

    if local_error is None:
        try:
            for pid, patch_writer in writers.items():
                patch_writer.finalize()
                _, data = read_patch_data(patch_writer.data_path)
                meta = Metadata.compute(
                    DataChunk.get_coords(data),
                    weights=DataChunk.getattr(data, "weights"),
                    center=_applied_center(centers_xyz, pid),
                )
                meta.to_file(patch_writer.cache_path / "meta.yml")
            if rank == 0:
                write_patch_ids_file(cache, num_patches)
        except Exception as err:
            local_error = err

    # per-process status exchange: every process learns of every error
    # (and so waits for the complete cache)
    failures = []
    for source in range(num_procs):
        payload = None
        if rank == source and local_error is not None:
            payload = dist.picklable_exception(local_error)
        status = dist.broadcast(payload, is_source=rank == source)
        if status is not None:
            failures.append((source, status))
    if failures:
        source, first = failures[0]
        raise RuntimeError(f"collective ingestion failed on process {source}") from first

    logger.info(
        "streamed %d patches (%s records) to cache over %d processes",
        num_patches, reader.num_records, num_procs,
    )
    return num_patches
