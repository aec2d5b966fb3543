"""Measurement configuration: correlation scales, redshift binning,
cosmology.

Capability parity with the reference ``yaw.config.classes``
(yaw/config/classes.py:54-874): :class:`ScalesConfig`
(scale limits, unit, optional power-law weighting), :class:`BinningConfig`
(generated or custom bin edges, closed side), and the top-level
:class:`Configuration` combining both with a cosmological model and worker
limit, including YAML round trips and cosmology serialisation by name.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.binning import Binning, parse_binning
from yet_another_wizz_tpu_torch.config.base import (
    BaseConfig,
    ConfigError,
    Parameter,
    ParamSpec,
    SequenceParameter,
)
from yet_another_wizz_tpu_torch.cosmology import (
    FLRWCosmology,
    RedshiftBinningFactory,
    Scales,
    TypeCosmology,
    cosmology_is_equal,
    get_default_cosmology,
    new_scales,
)
from yet_another_wizz_tpu_torch.options import BinMethod, Closed, NotSet, Unit, get_options

if TYPE_CHECKING:
    from typing import Any

    from numpy.typing import ArrayLike
    from typing_extensions import Self

__all__ = [
    "BinningConfig",
    "Configuration",
    "ScalesConfig",
    "cosmology_to_yaml",
    "yaml_to_cosmology",
]

KNOWN_COSMOLOGIES = {"Planck15": get_default_cosmology}


def cosmology_to_yaml(cosmology: TypeCosmology) -> str:
    """Serialise a cosmology to its registered name (custom cosmologies
    cannot be serialised and fall back to the default's name with a
    warning, mirroring the reference behaviour)."""
    if isinstance(cosmology, FLRWCosmology) and cosmology.name in KNOWN_COSMOLOGIES:
        return cosmology.name
    import warnings

    warnings.warn(
        "cannot serialise custom cosmologies to YAML, storing default name"
    )
    return get_default_cosmology().name


def yaml_to_cosmology(name: str) -> TypeCosmology:
    """Restore a cosmology from its registered name."""
    if name not in KNOWN_COSMOLOGIES:
        raise ConfigError(
            f"unknown cosmology '{name}', registered: "
            + ", ".join(KNOWN_COSMOLOGIES),
            "cosmology",
        )
    return KNOWN_COSMOLOGIES[name]()


class ScalesConfig(BaseConfig):
    """Correlation scale ranges with unit and optional separation weighting.

    Attributes mirror the reference: ``rmin``/``rmax`` (one or more scale
    limits), ``unit``, ``rweight`` (power-law exponent or None) and
    ``resolution`` (log sub-bins used to approximate the weighting).
    """

    _spec = ParamSpec(
        [
            SequenceParameter(
                "rmin", "lower scale limit(s)", float
            ),
            SequenceParameter(
                "rmax", "upper scale limit(s)", float
            ),
            Parameter(
                "unit",
                "unit of the scales",
                str,
                default=str(Unit.kpc),
                choices=get_options(Unit),
            ),
            Parameter(
                "rweight",
                "power-law exponent for weighting counts by separation",
                float,
                is_optional=True,
            ),
            Parameter(
                "resolution",
                "number of log bins to approximate the separation weighting",
                int,
                default=50,
            ),
            Parameter(
                "counting",
                "device counting formulation for weighted configurations",
                str,
                default="auto",
                choices=("auto", "cumulative", "direct"),
            ),
        ]
    )

    def __init__(
        self, rmin, rmax, unit, rweight, resolution, counting="auto"
    ) -> None:
        self.rmin = rmin if np.isscalar(rmin) else list(rmin)
        self.rmax = rmax if np.isscalar(rmax) else list(rmax)
        self.unit = Unit(unit)
        self.rweight = rweight
        self.resolution = resolution
        if counting not in ("auto", "cumulative", "direct"):
            raise ConfigError(
                "must be one of auto, cumulative, direct", "counting"
            )
        if counting == "direct" and rweight is None:
            raise ConfigError(
                "direct counting requires separation weighting ('rweight')",
                "counting",
            )
        self.counting = counting
        try:
            self.scales: Scales = new_scales(self.rmin, self.rmax, unit=self.unit)
        except ValueError as err:
            raise ConfigError(str(err), "rmin/rmax") from err

    @property
    def num_scales(self) -> int:
        """Number of scale ranges."""
        return self.scales.num_scales

    def to_dict(self) -> dict[str, Any]:
        result = super().to_dict()
        if len(result["rmin"]) == 1:
            result["rmin"] = result["rmin"][0]
            result["rmax"] = result["rmax"][0]
        return result


class BinningConfig(BaseConfig):
    """Redshift binning: generated (linear/comoving/logspace) or custom
    edges, with the closed interval side."""

    _spec = ParamSpec(
        [
            Parameter("zmin", "lowest redshift edge", float, is_optional=True),
            Parameter("zmax", "highest redshift edge", float, is_optional=True),
            Parameter(
                "num_bins", "number of redshift bins", int, default=30
            ),
            Parameter(
                "method",
                "binning generation method",
                str,
                default=str(BinMethod.linear),
                choices=get_options(BinMethod),
            ),
            SequenceParameter(
                "edges", "custom bin edges", float, is_optional=True
            ),
            Parameter(
                "closed",
                "which side of the bin edges is closed",
                str,
                default=str(Closed.right),
                choices=get_options(Closed),
            ),
        ]
    )

    def __init__(
        self, zmin, zmax, num_bins, method, edges, closed, cosmology=None
    ) -> None:
        self.closed = Closed(closed)

        if edges is not None:
            self.method = BinMethod.custom
            self.binning = Binning(parse_binning(edges), closed=self.closed)
            self.zmin = float(self.binning.edges[0])
            self.zmax = float(self.binning.edges[-1])
            self.num_bins = len(self.binning)
            self.edges = list(map(float, self.binning.edges))
            return

        if zmin is None or zmax is None:
            raise ConfigError(
                "either 'edges' or 'zmin' and 'zmax' are required", "zmin/zmax"
            )
        if zmin >= zmax:
            raise ConfigError("'zmin' must be smaller than 'zmax'", "zmin")

        self.method = BinMethod(method)
        if self.method == BinMethod.custom:
            raise ConfigError(
                "method 'custom' requires 'edges'", "method"
            )
        factory = RedshiftBinningFactory(cosmology)
        self.binning = factory.get_method(str(self.method))(
            zmin, zmax, num_bins, closed=self.closed
        )
        self.zmin = float(zmin)
        self.zmax = float(zmax)
        self.num_bins = int(num_bins)
        self.edges = None

    @property
    def is_custom(self) -> bool:
        """Whether the bin edges were provided by the user (reference:
        yaw/config/classes.py:352)."""
        return self.method == BinMethod.custom

    def to_dict(self) -> dict[str, Any]:
        if self.method == BinMethod.custom:
            return dict(
                edges=self.edges,
                method=str(self.method),
                closed=str(self.closed),
            )
        return dict(
            zmin=self.zmin,
            zmax=self.zmax,
            num_bins=self.num_bins,
            method=str(self.method),
            closed=str(self.closed),
        )


class Configuration(BaseConfig):
    """Top-level measurement configuration: scales, binning, cosmology.

    Create with :meth:`create`, e.g.::

        config = Configuration.create(
            rmin=100, rmax=1000, unit="kpc",
            zmin=0.1, zmax=1.2, num_bins=22,
        )
    """

    _spec = ParamSpec(
        [
            Parameter(
                "cosmology",
                "cosmological model (registered name)",
                str,
                default="Planck15",
            ),
            Parameter(
                "max_workers",
                "limit the number of parallel workers",
                int,
                is_optional=True,
            ),
        ],
        sections=dict(scales=ScalesConfig, binning=BinningConfig),
    )

    def __init__(
        self,
        scales: ScalesConfig,
        binning: BinningConfig,
        cosmology="Planck15",
        max_workers=None,
    ) -> None:
        self.scales = scales
        self.binning = binning
        if isinstance(cosmology, str):
            self.cosmology = yaml_to_cosmology(cosmology)
        else:
            self.cosmology = cosmology
        self.max_workers = max_workers

    @classmethod
    def from_dict(cls: type[Self], the_dict: dict[str, Any]) -> Self:
        the_dict = dict(the_dict)
        cosmology = the_dict.pop("cosmology", "Planck15")
        if isinstance(cosmology, str):
            cosmology = yaml_to_cosmology(cosmology)
        max_workers = the_dict.pop("max_workers", None)

        scales_dict = the_dict.pop("scales", None)
        binning_dict = the_dict.pop("binning", None)
        if scales_dict is None or binning_dict is None:
            raise ConfigError(
                "both 'scales' and 'binning' sections are required"
            )
        try:
            scales = (
                scales_dict
                if isinstance(scales_dict, ScalesConfig)
                else ScalesConfig.from_dict(scales_dict)
            )
        except ConfigError as err:
            raise err.add_level("scales") from err
        try:
            if isinstance(binning_dict, BinningConfig):
                binning = binning_dict
            else:
                parsed = BinningConfig._parse_items(dict(binning_dict))
                binning = BinningConfig(cosmology=cosmology, **parsed)
        except ConfigError as err:
            raise err.add_level("binning") from err

        if the_dict:
            raise ConfigError(
                "unknown configuration parameter(s): "
                + ", ".join(sorted(the_dict))
            )
        return cls(scales, binning, cosmology, max_workers)

    @classmethod
    def create(
        cls: type[Self],
        *,
        cosmology="Planck15",
        max_workers: int | None = None,
        # scales
        rmin: ArrayLike | None = None,
        rmax: ArrayLike | None = None,
        unit: Unit | str = Unit.kpc,
        rweight: float | None = None,
        resolution: int = 50,
        counting: str = "auto",
        # binning
        zmin: float | None = None,
        zmax: float | None = None,
        num_bins: int = 30,
        method: BinMethod | str = BinMethod.linear,
        edges: ArrayLike | None = None,
        closed: Closed | str = Closed.right,
    ) -> Self:
        """Create a new configuration from flat keyword arguments."""
        # raw strings pass through so invalid choices surface as ConfigError
        scales = dict(
            rmin=rmin, rmax=rmax, unit=str(unit),
            rweight=rweight, resolution=resolution, counting=counting,
        )
        binning = dict(
            zmin=zmin, zmax=zmax, num_bins=num_bins,
            method=str(method),
            edges=None if edges is None else list(np.asarray(edges, float)),
            closed=str(closed),
        )
        cosmo_value = (
            cosmology if isinstance(cosmology, str) else cosmology
        )
        return cls.from_dict(
            dict(
                scales=scales,
                binning=binning,
                cosmology=cosmo_value,
                max_workers=max_workers,
            )
        )

    def modify(self: Self, **updates: Any) -> Self:
        """Derive a new configuration with flat keyword updates (same
        parameter names as :meth:`create`)."""
        flat = dict(
            cosmology=cosmology_to_yaml(self.cosmology),
            max_workers=self.max_workers,
            rmin=self.scales.rmin,
            rmax=self.scales.rmax,
            unit=str(self.scales.unit),
            rweight=self.scales.rweight,
            resolution=self.scales.resolution,
            counting=self.scales.counting,
            closed=str(self.binning.closed),
        )
        if self.binning.method == BinMethod.custom:
            flat.update(edges=self.binning.edges, method="custom")
        else:
            flat.update(
                zmin=self.binning.zmin,
                zmax=self.binning.zmax,
                num_bins=self.binning.num_bins,
                method=str(self.binning.method),
            )
        for key, value in updates.items():
            if value is not NotSet:
                flat[key] = value
        if "edges" in updates and updates["edges"] is not None:
            flat.pop("zmin", None)
            flat.pop("zmax", None)
            flat["method"] = "custom"
        return type(self).create(**flat)

    def to_dict(self) -> dict[str, Any]:
        return dict(
            scales=self.scales.to_dict(),
            binning=self.binning.to_dict(),
            cosmology=cosmology_to_yaml(self.cosmology),
            max_workers=self.max_workers,
        )

    def __eq__(self, other: Any) -> bool:
        if type(self) is not type(other):
            return NotImplemented
        return (
            self.scales == other.scales
            and self.binning.binning == other.binning.binning
            and cosmology_is_equal(self.cosmology, other.cosmology)
        )

    __hash__ = None
    # from_file/to_file inherited from BaseConfig (YAML round trip)
