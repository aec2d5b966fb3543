"""Pipeline orchestration: lock file, setup handling and the run loop.

Ported from the JAX package's ``cli/pipeline.py`` (the reference's
``yaw.cli.pipeline``, yaw/cli/pipeline.py:28-422): a lock file detecting
crashed or concurrent runs, setup reading/writing into the project
directory, optional external cache location (symlinked), and the
task-queue run loop with per-task timing.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from timeit import default_timer
from typing import TYPE_CHECKING

from yet_another_wizz_tpu_torch.cli.config import ProjectConfig
from yet_another_wizz_tpu_torch.cli.directory import ProjectDirectory
from yet_another_wizz_tpu_torch.cli.tasks import TaskList
from yet_another_wizz_tpu_torch.utils.logging import (
    CLIENT,
    get_logger,
    init_file_logging,
)
from yet_another_wizz_tpu_torch.utils.misc import format_time

if TYPE_CHECKING:
    from typing_extensions import Self

__all__ = [
    "LockFile",
    "Pipeline",
    "run_setup",
]

logger = logging.getLogger(__name__)


def _clear_external_cache(cache_dir: Path) -> None:
    """Delete only the entries the pipeline itself creates inside an
    external cache directory (catalog pair caches + shared patch
    centers).

    Project creation ADOPTS a pre-existing user-supplied directory
    (``external.mkdir(exist_ok=True)``), so clearing it wholesale on
    overwrite could destroy foreign contents; unexpected entries are
    kept and logged instead. Deletion errors propagate: a partially
    cleared cache that went unnoticed would hand the new run the old
    run's patch centers."""
    import re
    import shutil

    pipeline_entry = re.compile(r"^(reference|unknown_\d+|patch_centers\.npy)$")
    foreign: list[str] = []
    for entry in sorted(cache_dir.iterdir()):
        if pipeline_entry.match(entry.name):
            if entry.is_dir() and not entry.is_symlink():
                shutil.rmtree(entry)
            else:
                entry.unlink()
        else:
            foreign.append(entry.name)
    if foreign:
        logger.warning(
            "external cache %s: keeping %d entr%s not created by the "
            "pipeline: %s",
            cache_dir, len(foreign), "y" if len(foreign) == 1 else "ies",
            ", ".join(foreign[:8]),
        )


class LockFile:
    """Guards a project against concurrent or resumed-after-crash runs.

    In multi-process jobs only the root process owns the lock; the other
    processes of the same job must not contend for it (they are
    participants, not concurrent runs)."""

    def __init__(self, path: Path | str) -> None:
        self.path = Path(path)

    def acquire(self, content: str = "") -> None:
        from yet_another_wizz_tpu_torch.parallel.distributed import run_on_root

        def acquire_on_root() -> None:
            if self.path.exists():
                raise RuntimeError(
                    f"a pipeline run appears to be in progress (or "
                    f"crashed); remove the lock file to continue: "
                    f"{self.path}"
                )
            self.path.write_text(f"{os.getpid()}:{content}")

        # outcome broadcast doubles as the barrier: a root-side error is
        # re-raised on every process instead of deadlocking the others
        run_on_root(acquire_on_root)

    def update(self, content: str) -> None:
        from yet_another_wizz_tpu_torch.parallel.distributed import on_root

        if on_root():
            self.path.write_text(f"{os.getpid()}:{content}")

    def release(self) -> None:
        from yet_another_wizz_tpu_torch.parallel.distributed import (
            barrier,
            on_root,
        )

        barrier("lock_release")
        if on_root():
            self.path.unlink(missing_ok=True)


class Pipeline:
    """A configured project with its scheduled task queue."""

    def __init__(
        self,
        project: ProjectDirectory,
        config: ProjectConfig,
        tasks: TaskList,
        *,
        progress: bool = False,
        device="cuda",
    ) -> None:
        self.project = project
        self.config = config
        self.tasks = tasks
        self.progress = progress
        self.device = device

    @classmethod
    def create(
        cls: type[Self],
        wdir: Path | str,
        setup_file: Path | str | None = None,
        *,
        cache_path: Path | str | None = None,
        overwrite: bool = False,
        resume: bool = False,
        progress: bool = False,
        max_workers: int | None = None,
        device="cuda",
    ) -> Self:
        """Create or reopen a project from a setup file.

        A new project copies the setup into ``pipeline.yml``; reopening
        without a setup file reuses the stored one. The tasks run on
        ``device`` (default ``"cuda"``, which raises without a card; it is
        not a setup key, so setup files stay those of the JAX package).
        """
        from yet_another_wizz_tpu_torch.ops.paircount import resolve_device

        device = resolve_device(device)
        wdir = Path(wdir)
        config_path = wdir / "pipeline.yml"

        from yet_another_wizz_tpu_torch.parallel.distributed import (
            barrier,
            broadcast,
            run_on_root,
        )

        # ALL filesystem-state branch decisions are root's view, broadcast
        # so every process takes the same path: per-rank checks race
        # against root's in-flight project creation (a slower rank would
        # see root's freshly written files, raise 'not empty' and leave
        # root deadlocked in the next collective)
        config_exists, not_empty = broadcast(
            (config_path.exists(), wdir.exists() and any(wdir.iterdir()))
        )
        if setup_file is None:
            if not config_exists:
                raise FileNotFoundError(
                    f"no setup found in project: {config_path}"
                )
            setup_file = config_path
        config = ProjectConfig.from_file(setup_file)

        if not_empty and not (overwrite or resume or config_exists):
            raise FileExistsError(f"project directory not empty: {wdir}")
        if overwrite and broadcast(wdir.exists()):
            barrier("pre_overwrite")  # nobody may still be reading it

            def remove_project() -> None:
                import shutil

                # an external (symlinked) cache holds this project's
                # catalogs: clear them too, or the new run silently
                # reuses the old run's patch centers and cached catalogs
                # (only pipeline-created entries — the directory may have
                # pre-existed with foreign contents)
                cache = wdir / "cache"
                # resolve() keeps a dangling link's target path; there is
                # nothing to clear when the user already deleted it
                if cache.is_symlink() and cache.resolve().is_dir():
                    _clear_external_cache(cache.resolve())
                shutil.rmtree(wdir)

            run_on_root(remove_project)

        indices = config.bin_indices
        project = ProjectDirectory(wdir, indices)

        def create_on_root() -> None:
            config.to_file(project.config_path)
            init_file_logging(project.log_path)

            if cache_path is not None or config.inputs.cache_path is not None:
                external = Path(cache_path or config.inputs.cache_path)
                internal = project.path / "cache"
                if not internal.exists():
                    external.mkdir(parents=True, exist_ok=True)
                    internal.symlink_to(external.resolve())

        run_on_root(create_on_root)

        tasks = TaskList(
            project, config,
            progress=progress, max_workers=max_workers, resume=resume,
            device=device,
        )
        return cls(project, config, tasks, progress=progress, device=device)

    def run(self) -> None:
        """Execute the scheduled tasks in order, guarded by the lock.

        When the blocked engine path is configured
        (``execution: max_resident_patches``), one ambient tile cache
        spans the whole task list: catalogs that recur across tasks (the
        reference sample appears in the autocorrelation AND every
        tomographic bin's cross-correlation) are packed and
        device-uploaded once per pipeline run instead of once per
        measurement — the budgets of
        :func:`~yet_another_wizz_tpu_torch.correlation.blocked.measurement_tile_cache`
        bound the resident/spilled bytes for the whole run."""
        import contextlib

        session_cache = contextlib.nullcontext()
        memo = contextlib.nullcontext()
        if self.config.execution.max_resident_patches is not None:
            from yet_another_wizz_tpu_torch.cli.directory import catalog_memo
            from yet_another_wizz_tpu_torch.correlation.blocked import (
                measurement_tile_cache,
            )

            session_cache = measurement_tile_cache()
            if self.config.execution.lazy:
                # cross-task block sharing needs the SAME catalog
                # objects: handles memoise their loads for the run (see
                # catalog_memo). Lazy catalogs only — memoising full
                # in-memory catalogs (`lazy: false`) would hold every
                # task's data in host memory simultaneously.
                memo = catalog_memo()

        lock = LockFile(self.project.lock_path)
        lock.acquire("starting")
        try:
            logger.log(CLIENT, "running %d task(s)", len(self.tasks))
            with session_cache, memo:
                self._run_tasks(lock)
        finally:
            lock.release()

    def _run_tasks(self, lock) -> None:
        for task in self.tasks:
            lock.update(task.name)
            # CLIENT level: user-facing progress, visible at the default
            # terminal level and always captured by the file log
            # (reference: cli/pipeline.py:315,333 logs these via
            # logger.client)
            logger.log(CLIENT, "running task '%s'", task.name)
            start = default_timer()
            task.run()
            logger.log(
                CLIENT,
                "task '%s' finished after %s",
                task.name,
                format_time(default_timer() - start),
            )

    def drop_cache(self) -> None:
        """Remove the cached catalogs (the reference's ``--drop`` flag)."""
        from yet_another_wizz_tpu_torch.parallel.distributed import (
            barrier,
            run_on_root,
        )

        barrier("pre_drop_cache")  # nobody may still be reading it

        def drop_on_root() -> None:
            import shutil

            cache = self.project.path / "cache"
            if cache.is_symlink():
                _clear_external_cache(cache.resolve())
                cache.unlink()
            elif cache.exists():
                shutil.rmtree(cache)
            logger.info("dropped cached catalogs")

        run_on_root(drop_on_root)


def run_setup(
    wdir: Path | str,
    setup_file: Path | str | None = None,
    *,
    cache_path: Path | str | None = None,
    workers: int | None = None,
    drop: bool = False,
    overwrite: bool = False,
    resume: bool = False,
    progress: bool = False,
    verbose: int = 0,
    quiet: bool = False,
    profile: bool = False,
    device="cuda",
) -> Pipeline:
    """Create and run a full pipeline from a YAML setup (the programmatic
    equivalent of the command-line tool).

    The tasks run on ``device`` (default ``"cuda"``, which raises without
    a card; ``"cpu"`` runs the plain PyTorch engine). With
    ``profile=True`` a ``torch.profiler`` trace of the task loop is
    written to ``<project>/profile/trace.json`` (a Chrome trace).

    In multi-process jobs (after :func:`yet_another_wizz_tpu_torch.parallel.
    initialize`) all processes execute the pipeline collectively: the
    measurements shard over the global device mesh while terminal/file
    logging and all product writes happen on the root process only."""
    from yet_another_wizz_tpu_torch.parallel.distributed import on_root

    if not quiet and on_root():
        level = {0: "info", 1: "debug"}.get(min(verbose, 1), "debug")
        get_logger(level, capture_exceptions=False)

    pipeline = Pipeline.create(
        wdir,
        setup_file,
        cache_path=cache_path,
        overwrite=overwrite,
        resume=resume,
        progress=progress,
        max_workers=workers,
        device=device,
    )
    if profile:
        from yet_another_wizz_tpu_torch.utils.logging import profile_trace

        trace_dir = pipeline.project.path / "profile"
        logger.info("writing profiler trace to: %s", trace_dir)
        with profile_trace(trace_dir):
            pipeline.run()
    else:
        pipeline.run()
    if drop:
        pipeline.drop_cache()
    return pipeline
