"""Declarative, YAML-serialisable measurement configuration."""

from yet_another_wizz_tpu_torch.config.base import ConfigError, Parameter, ParamSpec
from yet_another_wizz_tpu_torch.config.classes import (
    BinningConfig,
    Configuration,
    ScalesConfig,
)

__all__ = [
    "BinningConfig",
    "ConfigError",
    "Configuration",
    "Parameter",
    "ParamSpec",
    "ScalesConfig",
]
