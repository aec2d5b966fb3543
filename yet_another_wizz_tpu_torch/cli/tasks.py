"""Pipeline tasks and their dependency scheduling.

Ported from the JAX package's ``cli/tasks.py`` (the reference's
``yaw.cli.tasks``, yaw/cli/tasks.py:1-826). The task graph
(``#`` = required, ``|`` = optional)::

    cache_ref === auto_ref --+---------+
         #                   |         |
         #==== cross === estimate --- plot
         #                   |        |  |
    cache_unk === auto_unk --+--------+  |
         #=== hist ----------------------+

Users list the science tasks (``auto_ref``, ``auto_unk``, ``cross_corr``,
``estimate``, ``hist``, ``plot``) in the setup; the cache tasks are linked
automatically. Tasks validate their configuration requirements up front,
report completion for ``--resume``, and are executed in topological order.

Every task runs on the pipeline's ``device`` (default ``"cuda"``, which
raises without a card; nothing falls back to the CPU): the kmeans patch
assignment of the cache tasks and the pair counts of the measurement
tasks. The redshift histograms of ``hist`` are host numpy, as in the JAX
package.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from graphlib import TopologicalSorter
from typing import TYPE_CHECKING

from yet_another_wizz_tpu_torch.config.base import ConfigError
from yet_another_wizz_tpu_torch.utils.logging import CLIENT

if TYPE_CHECKING:
    from yet_another_wizz_tpu_torch.cli.config import ProjectConfig
    from yet_another_wizz_tpu_torch.cli.directory import ProjectDirectory

__all__ = [
    "Task",
    "TaskError",
    "TaskList",
]

logger = logging.getLogger(__name__)

_REGISTRY: dict[str, type["Task"]] = {}


class TaskError(Exception):
    pass


class Task(ABC):
    """One unit of pipeline work with declared dependencies."""

    name: str
    requires: tuple[str, ...] = ()
    optional: tuple[str, ...] = ()
    allowed_options: tuple[str, ...] = ()

    def __init_subclass__(cls) -> None:
        super().__init_subclass__()
        if hasattr(cls, "name"):
            _REGISTRY[cls.name] = cls

    def __init__(
        self,
        project: ProjectDirectory,
        config: ProjectConfig,
        *,
        progress: bool = False,
        max_workers: int | None = None,
        options: dict | None = None,
        device="cuda",
    ) -> None:
        self.project = project
        self.config = config
        self.progress = progress
        self.device = device
        # the CLI --workers flag overrides the setup file's
        # correlation.max_workers, like the reference
        # (yaw/cli/commandline.py:129-134)
        if max_workers is None:
            max_workers = config.correlation.max_workers
        self.max_workers = max_workers
        self.options = dict(options or {})
        unknown = set(self.options) - set(self.allowed_options)
        if unknown:
            raise ConfigError(
                f"task '{self.name}' does not accept option(s): "
                f"{', '.join(sorted(unknown))}",
                f"tasks.{self.name}",
            )

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"

    def check_config(self, scheduled: set[str]) -> None:
        """Raise if the project configuration cannot support this task."""

    @abstractmethod
    def completed(self) -> bool:
        """Whether all outputs of this task already exist."""

    @abstractmethod
    def run(self) -> None:
        """Execute the task."""

    # -- shared helpers -----------------------------------------------------

    def _require_reference(self) -> None:
        if self.config.inputs.reference is None:
            raise ConfigError(
                f"task '{self.name}' requires the reference sample",
                "inputs.reference",
            )

    def _require_unknown(self) -> None:
        if self.config.inputs.unknown is None:
            raise ConfigError(
                f"task '{self.name}' requires the unknown sample",
                "inputs.unknown",
            )

    def _require_patch_source(self, pair_config) -> None:
        """A cache task needs SOME patch source up front — failing here
        with the YAML path beats a raw ValueError deep inside ingestion
        after the input file was already read."""
        if pair_config.get_columns()["patches"] is not None:
            return
        if self.config.inputs.num_patches is not None:
            return
        # safe local read: validation runs before any task writes
        if self.project.cache.get_patch_centers() is not None:
            return
        raise ConfigError(
            f"task '{self.name}' has no patch source: set 'num_patches', "
            "a 'patches' column, or reuse a cache with stored patch "
            "centers",
            "inputs.num_patches",
        )


def _create_catalog_pair(project, pair_config, cache_handle, num_patches,
                         *, progress, max_workers, device):
    """Create cached data (and optional random) catalogs for one input
    pair, establishing shared patch centers on first use. The random
    catalog is created first so patch centers derive from the (smoother)
    randoms when generated here."""
    from yet_another_wizz_tpu_torch.catalog import Catalog
    from yet_another_wizz_tpu_torch.parallel.distributed import run_on_root

    # drop any stale pair sentinel first: the jobs below re-ingest with
    # overwrite=True, and a crash between the old cache's deletion and the
    # new one's completion must leave the pair observably incomplete
    cache_handle.clear_complete()
    columns = pair_config.get_columns()
    jobs = [
        (cache_handle.rand.path, pair_config.path_rand),
        (cache_handle.data.path, pair_config.path_data),
    ]
    for cache_path, input_path in jobs:
        if input_path is None:
            logger.info("skipping unconfigured random catalog")
            continue
        if columns["patches"] is not None:
            patch_args = dict(patch_name=columns["patches"])
        else:
            # root's filesystem view, broadcast: a lagging rank reading
            # the centers file locally could miss root's in-flight write
            # and kmeans its own, diverging centers inside collectives
            patch_args = dict(
                patch_centers=run_on_root(project.cache.get_patch_centers),
                patch_num=num_patches,
            )
        catalog = Catalog.from_file(
            cache_path,
            input_path,
            ra_name=columns["ra"],
            dec_name=columns["dec"],
            weight_name=columns["weight"],
            redshift_name=columns["redshift"],
            kappa_name=columns["kappa"],
            **patch_args,
            overwrite=True,
            progress=progress,
            max_workers=max_workers,
            device=device,
        )
        project.cache.ensure_patch_centers(catalog.get_centers())
    cache_handle.mark_complete()


class CacheRefTask(Task):
    name = "cache_ref"

    def check_config(self, scheduled: set[str]) -> None:
        self._require_reference()
        self._require_patch_source(self.config.inputs.reference)

    def completed(self) -> bool:
        return self.project.cache.reference.exists(
            expect_rand=self.config.inputs.reference.path_rand is not None
        )

    def run(self) -> None:
        _create_catalog_pair(
            self.project,
            self.config.inputs.reference,
            self.project.cache.reference,
            self.config.inputs.num_patches,
            progress=self.progress,
            max_workers=self.max_workers,
            device=self.device,
        )


class CacheUnkTask(Task):
    name = "cache_unk"

    def check_config(self, scheduled: set[str]) -> None:
        self._require_unknown()
        self._require_patch_source(self.config.inputs.unknown)

    def completed(self) -> bool:
        # tomographic rand paths are all-or-nothing (validated at config
        # parse), so one flag covers every bin's pair
        return self.project.cache.unknown.exists(
            expect_rand=self.config.inputs.unknown.path_rand is not None
        )

    def run(self) -> None:
        from yet_another_wizz_tpu_torch.cli.config import CatPairConfig

        unknown = self.config.inputs.unknown
        for index, data_path, rand_path in unknown.iter_bins():
            pair = CatPairConfig(
                data_path, rand_path, **unknown.get_columns()
            )
            _create_catalog_pair(
                self.project,
                pair,
                self.project.cache.unknown[index],
                self.config.inputs.num_patches,
                progress=self.progress,
                max_workers=self.max_workers,
                device=self.device,
            )


class AutoRefTask(Task):
    name = "auto_ref"
    requires = ("cache_ref",)

    def check_config(self, scheduled: set[str]) -> None:
        self._require_reference()
        if self.config.inputs.reference.path_rand is None:
            raise ConfigError(
                "task 'auto_ref' requires reference sample randoms",
                "inputs.reference.path_rand",
            )

    def completed(self) -> bool:
        return self.project.paircounts.auto_ref.exists()

    def run(self) -> None:
        from yet_another_wizz_tpu_torch.correlation.measurements import autocorrelate

        handle = self.project.cache.reference
        lazy = self.config.execution.lazy
        (corr,) = autocorrelate(
            self.config.correlation,
            handle.load_data(lazy=lazy),
            handle.load_rand(lazy=lazy),
            progress=self.progress,
            max_workers=self.max_workers,
            device=self.device,
            **self.config.execution.measurement_kwargs(self.device),
        )
        self.project.paircounts.auto_ref.save(corr)


class AutoUnkTask(Task):
    name = "auto_unk"
    requires = ("cache_unk",)

    def check_config(self, scheduled: set[str]) -> None:
        self._require_unknown()
        unknown = self.config.inputs.unknown
        if unknown.path_rand is None:
            raise ConfigError(
                "task 'auto_unk' requires unknown sample randoms",
                "inputs.unknown.path_rand",
            )
        if unknown.redshift is None:
            raise ConfigError(
                "task 'auto_unk' requires unknown sample redshifts",
                "inputs.unknown.redshift",
            )

    def completed(self) -> bool:
        return self.project.paircounts.auto_unk.exists()

    def run(self) -> None:
        from yet_another_wizz_tpu_torch.correlation.measurements import autocorrelate

        lazy = self.config.execution.lazy
        bins = list(self.project.cache.unknown.items())
        for number, (index, handle) in enumerate(bins, 1):
            # reference cli/tasks.py:176: per-bin progress at CLIENT
            logger.log(CLIENT, "processing bin %d / %d", number, len(bins))
            (corr,) = autocorrelate(
                self.config.correlation,
                handle.load_data(lazy=lazy),
                handle.load_rand(lazy=lazy),
                progress=self.progress,
                max_workers=self.max_workers,
                device=self.device,
                **self.config.execution.measurement_kwargs(self.device),
            )
            self.project.paircounts.auto_unk[index].save(corr)


class CrossCorrTask(Task):
    name = "cross_corr"
    requires = ("cache_ref", "cache_unk")

    def check_config(self, scheduled: set[str]) -> None:
        self._require_reference()
        self._require_unknown()
        has_ref_rand = self.config.inputs.reference.path_rand is not None
        has_unk_rand = self.config.inputs.unknown.path_rand is not None
        if not has_ref_rand and not has_unk_rand:
            raise ConfigError(
                "task 'cross_corr' requires reference and/or unknown "
                "sample randoms",
                "inputs",
            )

    def completed(self) -> bool:
        return self.project.paircounts.cross.exists()

    def run(self) -> None:
        from yet_another_wizz_tpu_torch.correlation.measurements import crosscorrelate

        lazy = self.config.execution.lazy
        reference = self.project.cache.reference.load_data(lazy=lazy)
        ref_rand = self.project.cache.reference.load_rand(lazy=lazy)
        bins = list(self.project.cache.unknown.items())
        for number, (index, handle) in enumerate(bins, 1):
            logger.log(CLIENT, "processing bin %d / %d", number, len(bins))
            (corr,) = crosscorrelate(
                self.config.correlation,
                reference,
                handle.load_data(lazy=lazy),
                ref_rand=ref_rand,
                unk_rand=handle.load_rand(lazy=lazy),
                progress=self.progress,
                max_workers=self.max_workers,
                device=self.device,
                **self.config.execution.measurement_kwargs(self.device),
            )
            self.project.paircounts.cross[index].save(corr)


class EstimateTask(Task):
    name = "estimate"
    requires = ("cross_corr",)
    optional = ("auto_ref", "auto_unk")
    allowed_options = ("method", "num_samples", "estimator")

    def check_config(self, scheduled: set[str]) -> None:
        pass

    def completed(self) -> bool:
        return self.project.estimate.nz_est.exists()

    def run(self) -> None:
        from yet_another_wizz_tpu_torch.redshifts import RedshiftData

        kwargs = dict(
            method=self.options.get("method", "jackknife"),
            num_samples=self.options.get("num_samples"),
            estimator=self.options.get("estimator"),
        )

        auto_ref_data = None
        if self.project.paircounts.auto_ref.exists():
            auto_ref = self.project.paircounts.auto_ref.load()
            auto_ref_data = auto_ref.sample(**kwargs)
            self.project.estimate.auto_ref.save(auto_ref_data)

        for index in self.project.indices:
            cross = self.project.paircounts.cross[index].load()
            cross_data = cross.sample(**kwargs)
            self.project.estimate.cross[index].save(cross_data)

            auto_unk_data = None
            if self.project.paircounts.auto_unk[index].exists():
                auto_unk = self.project.paircounts.auto_unk[index].load()
                auto_unk_data = auto_unk.sample(**kwargs)
                self.project.estimate.auto_unk[index].save(auto_unk_data)

            nz_est = RedshiftData.from_corrdata(
                cross_data, auto_ref_data, auto_unk_data
            )
            self.project.estimate.nz_est[index].save(nz_est)


class HistTask(Task):
    name = "hist"
    requires = ("cache_unk",)

    def check_config(self, scheduled: set[str]) -> None:
        self._require_unknown()
        if self.config.inputs.unknown.redshift is None:
            raise ConfigError(
                "task 'hist' requires unknown sample redshifts",
                "inputs.unknown.redshift",
            )

    def completed(self) -> bool:
        return self.project.true.nz_true.exists()

    def run(self) -> None:
        from yet_another_wizz_tpu_torch.redshifts import HistData

        lazy = self.config.execution.lazy
        for index, handle in self.project.cache.unknown.items():
            # lazy catalogs histogram block by block (bounded memory)
            hist = HistData.from_catalog(
                handle.load_data(lazy=lazy),
                self.config.correlation,
                progress=self.progress,
                max_workers=self.max_workers,
                max_resident_patches=(
                    self.config.execution.max_resident_patches
                ),
            )
            self.project.true.nz_true[index].save(hist)


class PlotTask(Task):
    name = "plot"
    requires = ()
    optional = ("estimate", "hist", "auto_ref", "auto_unk")

    def check_config(self, scheduled: set[str]) -> None:
        usable = {"estimate", "hist", "auto_ref", "auto_unk"}
        if not (usable & scheduled):
            raise ConfigError(
                "task 'plot' requires at least one of "
                "estimate/hist/auto_ref/auto_unk",
                "tasks",
            )

    def completed(self) -> bool:
        return False  # cheap; always regenerated

    def run(self) -> None:
        from yet_another_wizz_tpu_torch.parallel.distributed import run_on_root

        def plot_on_root() -> None:
            from yet_another_wizz_tpu_torch.cli import plotting

            plotting.make_checkplots(self.project)

        # outcome broadcast doubles as the barrier; root-side plot errors
        # are re-raised on every process instead of deadlocking the job
        run_on_root(plot_on_root)


class TaskList:
    """Parse, validate and topologically order the configured tasks."""

    def __init__(
        self,
        project: ProjectDirectory,
        config: ProjectConfig,
        *,
        progress: bool = False,
        max_workers: int | None = None,
        resume: bool = False,
        device="cuda",
    ) -> None:
        # entries are task names or single-key mappings name -> options
        task_options: dict[str, dict] = {}
        names = []
        for entry in config.tasks:
            if isinstance(entry, str):
                name, options = entry, {}
            elif isinstance(entry, dict) and len(entry) == 1:
                name, options = next(iter(entry.items()))
                if options is None:
                    options = {}
                if not isinstance(options, dict):
                    raise ConfigError(
                        f"task '{name}' options must be a mapping",
                        f"tasks.{name}",
                    )
            else:
                raise ConfigError(
                    "each task must be a name or a single-key mapping "
                    "of name to options",
                    "tasks",
                )
            if name not in names:
                names.append(name)
            task_options.setdefault(name, {}).update(options)
        unknown = [name for name in names if name not in _REGISTRY]
        if unknown:
            raise ConfigError(
                f"unknown task(s): {', '.join(unknown)}", "tasks"
            )

        # auto-link required parent tasks (cache_ref/cache_unk etc.)
        scheduled = set(names)
        stack = list(names)
        while stack:
            task_cls = _REGISTRY[stack.pop()]
            for parent in task_cls.requires:
                if parent not in scheduled:
                    scheduled.add(parent)
                    stack.append(parent)

        self.tasks = {
            name: _REGISTRY[name](
                project, config, progress=progress, max_workers=max_workers,
                options=task_options.get(name), device=device,
            )
            for name in scheduled
        }
        for task in self.tasks.values():
            task.check_config(scheduled)

        # deterministic tie-breaking: set iteration order is randomised
        # per process (string hashing), which would let cache_unk run
        # before cache_ref in some runs — and the first cached catalog
        # defines the kmeans patch centers. Sorted insertion pins the
        # order (and puts cache_ref first, so the reference sample always
        # defines the patches).
        graph = {
            name: sorted(
                set(_REGISTRY[name].requires)
                | (set(_REGISTRY[name].optional) & scheduled)
            )
            for name in sorted(scheduled)
        }
        order = list(TopologicalSorter(graph).static_order())

        # the completed() checks read the filesystem; in multi-process
        # jobs root decides and broadcasts so every rank runs the SAME
        # task queue (per-rank checks race against root's in-flight
        # writes and would desynchronise the collectives)
        from yet_another_wizz_tpu_torch.parallel.distributed import broadcast

        completed = broadcast(
            {name: self.tasks[name].completed() for name in order}
            if resume
            else {}
        )
        self.queue = []
        for name in order:
            task = self.tasks[name]
            if resume and completed.get(name, False):
                logger.info("skipping completed task '%s'", name)
                continue
            self.queue.append(task)

    def __len__(self) -> int:
        return len(self.queue)

    def __iter__(self):
        return iter(self.queue)
