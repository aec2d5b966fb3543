"""Project configuration for the batch pipeline.

Ported from the JAX package's ``cli/config.py`` (the reference's
``yaw.cli.config``, yaw/cli/config.py:39-471): the ``correlation:``
section (a :class:`~yet_another_wizz_tpu_torch.config.Configuration`), the
``inputs:`` section with a reference catalog pair and tomographic unknown
catalog pairs (integer-keyed path mappings), the patch count, and the
``tasks:`` list.
"""

from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING

from yet_another_wizz_tpu_torch.config import ConfigError, Configuration

if TYPE_CHECKING:
    from typing import Any

    from typing_extensions import Self

__all__ = [
    "CatPairConfig",
    "InputsConfig",
    "ProjectConfig",
    "ReferenceCatConfig",
    "UnknownCatConfig",
]


def _checked_path(path) -> Path:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"input file not found: {path}")
    return path


_COLUMN_KEYS = ("ra", "dec", "weight", "redshift", "kappa", "patches")


class CatPairConfig:
    """Paths and column names of one data/random catalog pair."""

    _required_columns = ("ra", "dec")

    def __init__(
        self,
        path_data,
        path_rand=None,
        *,
        ra: str | None = None,
        dec: str | None = None,
        weight: str | None = None,
        redshift: str | None = None,
        kappa: str | None = None,
        patches: str | None = None,
    ) -> None:
        self.path_data = path_data
        self.path_rand = path_rand
        self.ra = ra
        self.dec = dec
        self.weight = weight
        self.redshift = redshift
        self.kappa = kappa
        self.patches = patches

        for key in self._required_columns:
            if getattr(self, key) is None:
                raise ConfigError("parameter is required", key)

    @classmethod
    def from_dict(cls: type[Self], the_dict: dict[str, Any]) -> Self:
        the_dict = dict(the_dict)
        unknown = set(the_dict) - {"path_data", "path_rand", *_COLUMN_KEYS}
        if unknown:
            raise ConfigError(
                f"unknown configuration parameter(s): {', '.join(sorted(unknown))}"
            )
        if "path_data" not in the_dict:
            raise ConfigError("parameter is required", "path_data")
        return cls(
            the_dict.pop("path_data"), the_dict.pop("path_rand", None),
            **the_dict,
        )

    def to_dict(self) -> dict[str, Any]:
        result = dict(path_data=self._paths_builtin(self.path_data))
        if self.path_rand is not None:
            result["path_rand"] = self._paths_builtin(self.path_rand)
        for key in _COLUMN_KEYS:
            value = getattr(self, key)
            if value is not None:
                result[key] = value
        return result

    @staticmethod
    def _paths_builtin(paths):
        if isinstance(paths, dict):
            return {int(k): str(v) for k, v in paths.items()}
        return str(paths)

    def get_columns(self) -> dict[str, str | None]:
        """Mapping of catalog attribute to input column name."""
        return {key: getattr(self, key) for key in _COLUMN_KEYS}


class ReferenceCatConfig(CatPairConfig):
    """Reference sample inputs: redshifts are mandatory."""

    _required_columns = ("ra", "dec", "redshift")

    def __init__(self, path_data, path_rand=None, **kwargs) -> None:
        super().__init__(path_data, path_rand, **kwargs)
        self.path_data = _checked_path(path_data)
        self.path_rand = (
            None if path_rand is None else _checked_path(path_rand)
        )


class UnknownCatConfig(CatPairConfig):
    """Tomographic unknown sample inputs: paths are integer-keyed mappings
    from bin index to file path."""

    _required_columns = ("ra", "dec")

    def __init__(self, path_data, path_rand=None, **kwargs) -> None:
        super().__init__(path_data, path_rand, **kwargs)
        self.path_data = self._parse_mapping(path_data, "path_data")
        self.path_rand = (
            None
            if path_rand is None
            else self._parse_mapping(path_rand, "path_rand")
        )
        if self.path_rand is not None and set(self.path_rand) != set(
            self.path_data
        ):
            raise ConfigError(
                "bin indices of 'path_data' and 'path_rand' do not match",
                "path_rand",
            )

    @staticmethod
    def _parse_mapping(paths, name: str) -> dict[int, Path]:
        if not isinstance(paths, dict):
            paths = {1: paths}
        try:
            keys = [int(key) for key in paths]
        except (TypeError, ValueError) as err:
            raise ConfigError(
                f"cannot parse mapping keys to type int: {err}", name
            ) from err
        if len(set(keys)) != len(keys):
            # e.g. mixed 1 and "1", or floats truncating to the same int:
            # a silent dict collision would drop a tomographic bin
            raise ConfigError(
                "bin indices are not unique after integer conversion",
                name,
            )
        return {
            key: _checked_path(value)
            for key, value in zip(keys, paths.values())
        }

    @property
    def bin_indices(self) -> tuple[int, ...]:
        """The tomographic bin indices."""
        return tuple(sorted(self.path_data))

    def iter_bins(self):
        """Yield ``(bin_index, data_path, random_path)`` per bin."""
        for index in self.bin_indices:
            rand = None if self.path_rand is None else self.path_rand[index]
            yield index, self.path_data[index], rand


class InputsConfig:
    """The ``inputs:`` section: reference and unknown catalog pairs, patch
    count and optional external cache path."""

    def __init__(
        self,
        reference: ReferenceCatConfig | None,
        unknown: UnknownCatConfig | None,
        num_patches: int | None = None,
        cache_path: str | Path | None = None,
    ) -> None:
        self.reference = reference
        self.unknown = unknown
        if num_patches is not None:
            # validate up front: a bad value must not surface as a raw
            # error deep inside ingestion after reading the input file
            try:
                num_patches = int(num_patches)
            except (TypeError, ValueError) as err:
                raise ConfigError(
                    f"cannot parse to type int: {num_patches!r}",
                    "num_patches",
                ) from err
            if num_patches < 1:
                raise ConfigError(
                    "at least one patch is required", "num_patches"
                )
        self.num_patches = num_patches
        self.cache_path = None if cache_path is None else Path(cache_path)

    @classmethod
    def from_dict(cls: type[Self], the_dict: dict[str, Any]) -> Self:
        the_dict = dict(the_dict)
        unknown_keys = set(the_dict) - {
            "reference", "unknown", "num_patches", "cache_path",
        }
        if unknown_keys:
            raise ConfigError(
                "unknown configuration parameter(s): "
                + ", ".join(sorted(unknown_keys)),
            )
        try:
            reference = the_dict.get("reference")
            if reference is not None:
                reference = ReferenceCatConfig.from_dict(reference)
        except ConfigError as err:
            raise err.add_level("reference") from err
        try:
            unknown = the_dict.get("unknown")
            if unknown is not None:
                unknown = UnknownCatConfig.from_dict(unknown)
        except ConfigError as err:
            raise err.add_level("unknown") from err

        return cls(
            reference,
            unknown,
            the_dict.get("num_patches"),
            the_dict.get("cache_path"),
        )

    def to_dict(self) -> dict[str, Any]:
        result = {}
        if self.reference is not None:
            result["reference"] = self.reference.to_dict()
        if self.unknown is not None:
            result["unknown"] = self.unknown.to_dict()
        if self.num_patches is not None:
            result["num_patches"] = self.num_patches
        if self.cache_path is not None:
            result["cache_path"] = str(self.cache_path)
        return result


class ExecutionConfig:
    """Optional execution knobs: device pool and out-of-core mode.

    ``max_resident_patches`` routes the measurement tasks through the
    blocked engine path (device AND host memory bounded at one
    patch-block pair); ``lazy`` reopens the cached catalogs as
    :class:`~yet_another_wizz_tpu_torch.catalog.lazy.LazyCatalog` (defaults to
    true exactly when ``max_resident_patches`` is set, which the lazy
    path requires).

    ``devices`` pins the size of the device mesh the measurements run on
    (default: automatic — all local cards of a single-process job, the
    global mesh of a multi-process job; ``1`` forces single-device
    execution). ``data_sharding`` selects the catalog distribution over
    the mesh (``replicated``, ``columns`` or ``ring``, see
    :func:`yet_another_wizz_tpu_torch.parallel.count_pairs_sharded`).
    ``audit`` enables the exact-boundary float64 repair pass on every
    pair count (with ``max_resident_patches`` it runs per block pair;
    certification costs throughput).
    """

    DATA_SHARDINGS = ("replicated", "columns", "ring")

    def __init__(
        self,
        max_resident_patches: int | None = None,
        lazy: bool | None = None,
        devices: int | None = None,
        data_sharding: str = "replicated",
        audit: bool = False,
    ) -> None:
        if max_resident_patches is not None:
            max_resident_patches = int(max_resident_patches)
            if max_resident_patches < 1:
                raise ConfigError(
                    "must be a positive integer",
                    "max_resident_patches",
                )
        if lazy is None:
            lazy = max_resident_patches is not None
        if lazy and max_resident_patches is None:
            raise ConfigError(
                "lazy catalogs require 'max_resident_patches' (the "
                "blocked measurement path)",
                "lazy",
            )
        if devices is not None:
            devices = int(devices)
            if devices < 1:
                raise ConfigError("must be a positive integer", "devices")
        if data_sharding not in self.DATA_SHARDINGS:
            raise ConfigError(
                f"must be one of {', '.join(self.DATA_SHARDINGS)}",
                "data_sharding",
            )
        audit = bool(audit)
        self.max_resident_patches = max_resident_patches
        self.lazy = bool(lazy)
        self.devices = devices
        self.data_sharding = data_sharding
        self.audit = audit

    @classmethod
    def from_dict(cls: type[Self], the_dict: dict[str, Any]) -> Self:
        the_dict = dict(the_dict)
        unknown = set(the_dict) - {
            "max_resident_patches", "lazy", "devices", "data_sharding",
            "audit",
        }
        if unknown:
            raise ConfigError(
                f"unknown configuration parameter(s): "
                f"{', '.join(sorted(unknown))}"
            )
        return cls(**the_dict)

    def to_dict(self) -> dict[str, Any]:
        result: dict[str, Any] = {}
        if self.max_resident_patches is not None:
            result["max_resident_patches"] = self.max_resident_patches
            result["lazy"] = self.lazy
        if self.devices is not None:
            result["devices"] = self.devices
        if self.data_sharding != "replicated":
            result["data_sharding"] = self.data_sharding
        if self.audit:
            result["audit"] = self.audit
        return result

    def measurement_kwargs(self, device="cuda") -> dict[str, Any]:
        """Execution keyword arguments for the measurement functions
        (:func:`~yet_another_wizz_tpu_torch.correlation.measurements.autocorrelate`
        and friends) on ``device``: blocked mode, audit, and the device mesh
        resolved from ``devices`` (``None`` leaves automatic pool detection
        to the engine; ``1`` pins single-device execution; ``N`` takes
        :func:`~yet_another_wizz_tpu_torch.parallel.default_mesh`, the
        first ``N`` cards, or ``N`` entries of the CPU or of an indexed
        card)."""
        from yet_another_wizz_tpu_torch.parallel.distributed import (
            num_processes,
        )

        processes = num_processes()
        if processes > 1 and self.devices is not None:
            # multi-process jobs run collectives over the GLOBAL mesh, in
            # which every process holds the same number of shards; a mesh
            # that does not split over the processes would leave one out
            if self.devices % processes:
                raise ConfigError(
                    "in a multi-process job 'devices' must be unset or a "
                    f"multiple of the number of processes ({processes})",
                    "execution.devices",
                )
        if self.devices is None:
            mesh = None
        elif self.devices == 1 and processes == 1:
            mesh = "single"
        else:
            from yet_another_wizz_tpu_torch.parallel import default_mesh

            mesh = default_mesh(self.devices, device)
        return dict(
            max_resident_patches=self.max_resident_patches,
            audit=self.audit,
            mesh=mesh,
            data_sharding=self.data_sharding,
        )


class ProjectConfig:
    """The full project setup: correlation configuration, inputs, optional
    execution knobs and task list."""

    def __init__(
        self,
        correlation: Configuration,
        inputs: InputsConfig,
        tasks: list,
        execution: ExecutionConfig | None = None,
    ) -> None:
        self.correlation = correlation
        self.inputs = inputs
        self.tasks = list(tasks)
        self.execution = execution or ExecutionConfig()

    @classmethod
    def from_dict(cls: type[Self], the_dict: dict[str, Any]) -> Self:
        the_dict = dict(the_dict)
        unknown = set(the_dict) - {
            "correlation", "inputs", "tasks", "execution"
        }
        if unknown:
            raise ConfigError(
                f"unknown configuration parameter(s): {', '.join(sorted(unknown))}"
            )
        if "correlation" not in the_dict:
            raise ConfigError("section is required", "correlation")
        if "tasks" not in the_dict or not the_dict["tasks"]:
            raise ConfigError("at least one task is required", "tasks")

        try:
            correlation = Configuration.from_dict(the_dict["correlation"])
        except ConfigError as err:
            raise err.add_level("correlation") from err
        try:
            inputs = InputsConfig.from_dict(the_dict.get("inputs", {}))
        except ConfigError as err:
            raise err.add_level("inputs") from err
        try:
            # an `execution:` key with everything commented out parses to
            # None; treat it like an absent section
            execution = ExecutionConfig.from_dict(
                the_dict.get("execution") or {}
            )
        except ConfigError as err:
            raise err.add_level("execution") from err

        return cls(correlation, inputs, the_dict["tasks"], execution)

    def to_dict(self) -> dict[str, Any]:
        result = dict(
            correlation=self.correlation.to_dict(),
            inputs=self.inputs.to_dict(),
            tasks=list(self.tasks),
        )
        execution = self.execution.to_dict()
        if execution:
            result["execution"] = execution
        return result

    @classmethod
    def from_file(cls: type[Self], path: Path | str) -> Self:
        import yaml

        with Path(path).open() as f:
            return cls.from_dict(yaml.safe_load(f))

    def to_file(self, path: Path | str) -> None:
        import yaml

        with Path(path).open("w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    @property
    def bin_indices(self) -> tuple[int, ...]:
        """Tomographic bin indices from the unknown inputs (default: a
        single pseudo-bin when only the reference is configured)."""
        if self.inputs.unknown is None:
            return ()
        return self.inputs.unknown.bin_indices
