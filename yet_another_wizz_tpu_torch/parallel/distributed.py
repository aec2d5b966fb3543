"""Multi-process execution helpers over ``torch.distributed`` (gloo).

Ported from the JAX package's ``parallel/distributed.py`` (capability
parity with the reference's MPI communication layer,
yaw/utils/parallel.py:38-484): process-role helpers (:func:`on_root`),
collective broadcast of host-side values, a barrier and root-only work with
its outcome sent to every process. On a single process every helper
degrades to a no-op, like the reference's ``MockComm``.

The process group is gloo: its collectives move small host tensors (the
sharded engine's per-shard partials and pickled metadata), and NCCL would
refuse two ranks on one card, which is how a one-card machine runs a
multi-process job. The group's address, size and rank come from the
``YAWT_*`` variables or the arguments of :func:`initialize`, else from an
Open MPI launcher's environment. The data-plane reduction of the pair
counts lives in :mod:`yet_another_wizz_tpu_torch.parallel.sharded`.
"""

from __future__ import annotations

import functools
import logging
import os
import pickle
import re
from typing import TYPE_CHECKING

import numpy as np
import torch
import torch.distributed as dist

if TYPE_CHECKING:
    from collections.abc import Callable
    from typing import Any

__all__ = [
    "barrier",
    "broadcast",
    "broadcasted",
    "initialize",
    "num_processes",
    "on_root",
    "picklable_exception",
    "process_index",
    "run_on_root",
]

logger = logging.getLogger(__name__)

_initialized = False
_multiprocess = False  # set once a process group is up (started here or adopted)

ENV_COORDINATOR = "YAWT_COORDINATOR"
ENV_NUM_PROCESSES = "YAWT_NUM_PROCESSES"
ENV_PROCESS_ID = "YAWT_PROCESS_ID"

# world-size variables exported by common multi-process launchers, in
# detection order: Open MPI / mpiexec (ORTE), MPICH-style PMI, Slurm srun.
# For Slurm this must be the per-STEP task count (srun exports it for the
# tasks it spawns), not SLURM_NTASKS, which sbatch also exports into the
# batch step itself, where exactly one process exists.
_LAUNCHER_WORLD_SIZE_VARS = (
    "OMPI_COMM_WORLD_SIZE",
    "PMI_SIZE",
    "SLURM_STEP_NUM_TASKS",
)

_ORTE_URI = "OMPI_MCA_orte_hnp_uri"


def _launched_world_size() -> int | None:
    """World size advertised by an MPI-style launcher environment, or None
    when not running under one (the reference asks mpi4py,
    yaw/utils/parallel.py:88-99)."""
    for var in _LAUNCHER_WORLD_SIZE_VARS:
        value = os.environ.get(var)
        if value is not None:
            try:
                return int(value)
            except ValueError:  # malformed launcher env; ignore it
                return None
    return None


def _ompi_cluster() -> tuple[str, int, int] | None:
    """``(coordinator, size, rank)`` of an Open MPI launch, derived as the
    JAX package's cluster detection does (``OmpiCluster``): the launcher's
    first IP address from the ORTE URI, and a port in the top 2^12 of the
    ephemeral range from the job id. None when the environment does not
    hold the URI and the rank."""
    uri = os.environ.get(_ORTE_URI)
    rank = os.environ.get("OMPI_COMM_WORLD_RANK")
    size = os.environ.get("OMPI_COMM_WORLD_SIZE")
    if uri is None or rank is None or size is None:
        return None
    match = re.search(r"tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]", uri)
    if match is None:
        return None
    host = next(group for group in match.groups() if group is not None)
    job = int(uri.split(".", maxsplit=1)[0]) // 2**12
    port = job % 2**12 + (65535 - 2**12 + 1)
    return f"{host}:{port}", int(size), int(rank)


def initialize(
    coordinator_address: str | None = None,
    process_count: int | None = None,
    process_id: int | None = None,
) -> None:
    """Start the gloo process group of a multi-process job (no-op when
    already initialised or when running as one process with no
    coordinator).

    Arguments default to the ``YAWT_COORDINATOR`` (``host:port``; the
    process with id 0 listens there) / ``YAWT_NUM_PROCESSES`` /
    ``YAWT_PROCESS_ID`` environment variables, so a launcher only needs to
    export those before starting each process. When neither is given but
    the process was started by an MPI-style launcher with more than one
    rank, the configuration is derived from an Open MPI environment; any
    other launcher environment raises with the variables to export.
    """
    global _initialized, _multiprocess
    coordinator_address = coordinator_address or os.environ.get(
        ENV_COORDINATOR
    )
    if process_count is None and ENV_NUM_PROCESSES in os.environ:
        process_count = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and ENV_PROCESS_ID in os.environ:
        process_id = int(os.environ[ENV_PROCESS_ID])

    if _initialized:
        if not _multiprocess and (
            coordinator_address is not None
            or process_count not in (None, 1)
            or (process_count is None and (_launched_world_size() or 1) > 1)
        ):
            # an earlier argument-less call latched single-process mode; a
            # silent no-op here would strand this process outside the job
            # while its peers block waiting for it
            raise RuntimeError(
                "initialize() was already called in single-host mode; "
                "a multi-host cluster must be initialised before any "
                "argument-less initialize() call"
            )
        return

    if _cluster_active():
        # the caller started the process group itself
        _multiprocess = _initialized = True
        return
    if coordinator_address is None and process_count in (None, 1):
        launched = _launched_world_size()
        if process_count == 1 or launched is None or launched <= 1:
            _initialized = True  # one process, nothing to set up
            return
        cluster = _ompi_cluster()
        if cluster is None:
            raise RuntimeError(
                f"running under a multi-process launcher (world size "
                f"{launched}) but the job's configuration cannot be derived "
                f"from its environment; export {ENV_COORDINATOR}/"
                f"{ENV_NUM_PROCESSES}/{ENV_PROCESS_ID} explicitly"
            )
        coordinator_address, process_count, process_id = cluster
    if coordinator_address is None or process_count is None or process_id is None:
        raise ValueError(
            "a multi-process job needs a coordinator address, the number of "
            "processes and this process's id"
        )
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(
        "gloo", init_method=coordinator_address, world_size=process_count,
        rank=process_id,
    )
    _multiprocess = True
    _initialized = True
    logger.info("initialised process %d of %d", process_index(), num_processes())


def _cluster_active() -> bool:
    """Whether a process group is up (this module's or the caller's)."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """Index of this process (0 in a single-process job)."""
    return dist.get_rank() if _cluster_active() else 0


def num_processes() -> int:
    """Number of processes in the job."""
    return dist.get_world_size() if _cluster_active() else 1


def on_root() -> bool:
    """Whether this process performs root-only work (logging, file I/O),
    the analogue of the reference's ``parallel.on_root()``."""
    return process_index() == 0


def barrier(name: str = "yawt_barrier") -> None:
    """Synchronise all processes (no-op in a single-process job). ``name``
    labels the barrier in the JAX package and is not used here."""
    if num_processes() > 1:
        dist.barrier()


def _broadcast_payload(payload: bytes, *, is_source: bool) -> bytes:
    """Wire part of :func:`broadcast`: send pre-pickled bytes from the one
    process with ``is_source`` to all processes and return them everywhere.
    The lengths are exchanged first (which also names the source), then
    the payload."""
    lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(num_processes())]
    mine = torch.tensor([len(payload) if is_source else -1], dtype=torch.int64)
    dist.all_gather(lengths, mine)
    sources = [rank for rank, length in enumerate(lengths) if length.item() >= 0]
    if len(sources) != 1:
        raise ValueError(f"a broadcast needs one source process, got {sources}")
    (source,) = sources
    if is_source:
        buffer = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    else:
        buffer = torch.zeros(int(lengths[source].item()), dtype=torch.uint8)
    if len(buffer):
        dist.broadcast(buffer, src=source)
    return buffer.numpy().tobytes()


def broadcast(value: Any, *, is_source: bool | None = None) -> Any:
    """Broadcast an arbitrary picklable host-side value from the root
    process (or the one process with ``is_source``) to all processes, the
    analogue of the reference's ``bcast_auto``; small metadata only."""
    if num_processes() == 1:
        return value
    if is_source is None:
        is_source = on_root()
    payload = pickle.dumps(value) if is_source else b""
    return pickle.loads(_broadcast_payload(payload, is_source=is_source))


def picklable_exception(exc: BaseException) -> BaseException:
    """The exception itself if it survives a pickle round trip, else a
    RuntimeError carrying its repr: safe to send through :func:`broadcast`
    without stranding the receiving processes mid-collective."""
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:
        return RuntimeError(f"remote process failed: {exc!r}")


def run_on_root(func: Callable, *args: Any, **kwargs: Any) -> Any:
    """Execute ``func(*args, **kwargs)`` on the root process only and
    propagate its outcome, return value or exception, to every process.

    A root-side exception cannot deadlock the other processes at a
    barrier: the broadcast outcome is the synchronisation point, and a
    root failure is raised on all processes."""
    if num_processes() == 1:
        return func(*args, **kwargs)
    if on_root():
        try:
            outcome = ("ok", func(*args, **kwargs))
        except BaseException as exc:
            outcome = ("error", exc)
        # the outcome must survive the pickled broadcast in both
        # directions, or the other processes would be stranded: verify once
        # and send the same bytes
        try:
            wire = pickle.dumps(outcome)
            pickle.loads(wire)
        except Exception:
            status, payload = outcome
            outcome = (
                "error",
                RuntimeError(
                    f"root outcome is not picklable ({status}): {payload!r}"
                ),
            )
            wire = pickle.dumps(outcome)
        _broadcast_payload(wire, is_source=True)
        status, payload = outcome
    else:
        status, payload = pickle.loads(_broadcast_payload(b"", is_source=False))
    if status == "error":
        raise payload
    return payload


def broadcasted(func: Callable) -> Callable:
    """Decorator: run ``func`` on the root process only and broadcast its
    outcome to all processes (the reference's ``@broadcasted``,
    yaw/utils/parallel.py:189-208)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        return run_on_root(func, *args, **kwargs)

    return wrapper
