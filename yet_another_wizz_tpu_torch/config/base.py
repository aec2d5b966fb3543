"""Declarative configuration machinery.

Capability parity with the reference ``yaw.config.base``
(yaw/config/base.py:45-556): typed parameter
specifications with defaults, choices and help text; hierarchical
attribute-path error reporting (:class:`ConfigError`); immutable config
objects with ``create()``/``modify()``; YAML round trips; and
self-documenting commented-YAML generation for the CLI ``--dump`` feature.
"""

from __future__ import annotations

from abc import ABC
from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.options import NotSet

if TYPE_CHECKING:
    from collections.abc import Callable, Iterable
    from typing import Any

    from typing_extensions import Self

__all__ = [
    "BaseConfig",
    "ConfigError",
    "Parameter",
    "ParamSpec",
    "SequenceParameter",
]


class ConfigError(Exception):
    """Configuration error carrying the dotted attribute path of the
    offending parameter (e.g. ``binning.zmin``)."""

    def __init__(self, msg: str, attr: str = "") -> None:
        self.msg = msg
        self.attr = attr
        super().__init__(f"{attr}: {msg}" if attr else msg)

    def add_level(self, level: str) -> ConfigError:
        """Prefix a section name onto the attribute path."""
        if level:
            self.attr = f"{level}.{self.attr}" if self.attr else level
        args = list(self.args)
        args[0] = f"{self.attr}: {self.msg}" if self.attr else self.msg
        self.args = tuple(args)
        return self


@dataclass
class Parameter:
    """Specification of a single scalar configuration parameter."""

    name: str
    help: str
    type: type
    is_optional: bool = False
    default: Any = NotSet
    choices: tuple = ()
    to_builtin: Callable[[Any], Any] | None = None
    to_type: Callable[[Any], Any] | None = None

    def __post_init__(self) -> None:
        if self.to_type is None:
            self.to_type = self.type
        if self.default is not NotSet and self.default is not None:
            self.default = self.parse(self.default)
        if self.is_optional and self.default is NotSet:
            self.default = None

    @property
    def required(self) -> bool:
        return self.default is NotSet and not self.is_optional

    @property
    def has_choices(self) -> bool:
        """Whether only a limited set of values is accepted (reference:
        yaw/config/base.py:224)."""
        return bool(self.choices)

    def parse(self, value: Any) -> Any:
        """Validate and coerce a raw value."""
        if value is None:
            if self.is_optional:
                return None
            raise ConfigError("value is required and cannot be None", self.name)
        try:
            parsed = self.to_type(value)
        except ConfigError:
            raise
        except Exception as err:
            # any converter failure (incl. KeyError/AttributeError from a
            # custom to_type) must carry the dotted parameter path
            raise ConfigError(
                f"cannot convert to type {self.type.__name__}: {err!r}",
                self.name,
            ) from err
        if self.choices and parsed not in self.choices:
            options = ", ".join(str(c) for c in self.choices)
            raise ConfigError(
                f"invalid value '{value}', allowed: {options}", self.name
            )
        return parsed

    def as_builtin(self, value: Any) -> Any:
        """Convert a parsed value back to YAML-friendly builtins."""
        if value is None:
            return None
        if self.to_builtin is not None:
            return self.to_builtin(value)
        if isinstance(value, np.generic):
            return value.item()
        if isinstance(value, str):
            return str(value)  # normalises StrEnum members to plain str
        return value

    def format_yaml_doc(self, indent: int = 0, padding: int = 2) -> str:
        """One commented YAML line for this parameter: help text,
        required marker, allowed choices, and the default value
        (reference: yaw/config/base.py:258-292)."""
        pad = "  " * indent
        comment = self.help.rstrip()
        if self.required:
            # keep a trailing period where the help text had one
            # (reference: yaw/config/base.py:281-283)
            end = "." if comment.endswith(".") else ""
            comment = comment.rstrip(".") + ", required" + end
        if self.has_choices:
            options = ", ".join(str(c) for c in self.choices)
            comment += f" (choices: {options})"
        value = "" if self.required else self.as_builtin(self.default)
        shown = "" if value is None else value
        return f"{pad}{self.name}: {shown}{' ' * padding}# {comment}"


@dataclass
class SequenceParameter(Parameter):
    """A parameter holding a list of values of a common scalar type."""

    def parse(self, value: Any) -> Any:
        if value is None:
            if self.is_optional:
                return None
            raise ConfigError("value is required and cannot be None", self.name)
        if np.ndim(value) == 0:
            value = [value]
        try:
            return [self.to_type(item) for item in value]
        except ConfigError:
            raise
        except Exception as err:
            raise ConfigError(
                f"cannot convert items to type {self.type.__name__}: {err!r}",
                self.name,
            ) from err

    def as_builtin(self, value: Any) -> Any:
        if value is None:
            return None
        items = [
            item.item() if isinstance(item, np.generic) else item
            for item in np.ravel(np.asarray(value)).tolist()
        ]
        return items


class ParamSpec:
    """Ordered collection of parameters and nested sections of a config
    class; drives parsing, serialisation and YAML documentation."""

    def __init__(
        self,
        params: Iterable[Parameter] = (),
        sections: dict[str, type[BaseConfig]] | None = None,
    ) -> None:
        self.params = {p.name: p for p in params}
        self.sections = dict(sections or {})

    def known_keys(self) -> set[str]:
        return set(self.params) | set(self.sections)


class BaseConfig(ABC):
    """Base class for immutable configuration objects.

    Subclasses define ``_spec`` (a :class:`ParamSpec`); instances are
    created with :meth:`create`, derived with :meth:`modify`, and
    round-trip through :meth:`to_dict` / :meth:`from_dict` and YAML.
    """

    _spec: ParamSpec

    @classmethod
    def _parse_items(cls, the_dict: dict[str, Any]) -> dict[str, Any]:
        unknown = set(the_dict) - cls._spec.known_keys()
        if unknown:
            raise ConfigError(
                f"unknown configuration parameter(s): {', '.join(sorted(unknown))}"
            )
        parsed = {}
        for name, param in cls._spec.params.items():
            if name in the_dict:
                parsed[name] = param.parse(the_dict[name])
            elif param.required:
                raise ConfigError("parameter is required", name)
            else:
                parsed[name] = param.default
        for name, section_cls in cls._spec.sections.items():
            sub = the_dict.get(name, {})
            try:
                if isinstance(sub, section_cls):
                    parsed[name] = sub
                else:
                    parsed[name] = section_cls.from_dict(sub or {})
            except ConfigError as err:
                raise err.add_level(name) from err
        return parsed

    @classmethod
    def get_paramspec(cls) -> dict[str, Any]:
        """Mapping of parameter name to its metadata — scalar/sequence
        parameters and nested config-section classes (reference:
        yaw/config/base.py:423-425)."""
        spec: dict[str, Any] = dict(cls._spec.params)
        spec.update(cls._spec.sections)
        return spec

    @classmethod
    def from_dict(cls: type[Self], the_dict: dict[str, Any]) -> Self:
        """Create an instance from a (nested) dictionary of raw values."""
        return cls(**cls._parse_items(dict(the_dict)))

    @classmethod
    def create(cls: type[Self], **kwargs: Any) -> Self:
        """Create an instance from keyword arguments."""
        return cls.from_dict(kwargs)

    def modify(self: Self, **updates: Any) -> Self:
        """Derive a new instance with the given parameters replaced."""
        current = self.to_dict()
        for key, value in updates.items():
            if value is not NotSet:
                current[key] = value
        return type(self).from_dict(current)

    def to_dict(self) -> dict[str, Any]:
        """Represent this configuration as YAML-compatible builtins."""
        result = {}
        for name, param in self._spec.params.items():
            result[name] = param.as_builtin(getattr(self, name))
        for name in self._spec.sections:
            result[name] = getattr(self, name).to_dict()
        return result

    @classmethod
    def from_file(cls: type[Self], path) -> Self:
        """Restore an instance from a YAML file (every config class is
        file-serialisable, like the reference's YamlSerialisable base,
        yaw/config/base.py:409)."""
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    def to_file(self, path) -> None:
        """Write this configuration to a YAML file."""
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def __eq__(self, other: Any) -> bool:
        if type(self) is not type(other):
            return NotImplemented
        return self.to_dict() == other.to_dict()

    __hash__ = None

    @classmethod
    def format_yaml_doc(cls, indent: int = 0) -> str:
        """Render a fully commented YAML document of all parameters with
        their defaults and help strings, one
        :meth:`Parameter.format_yaml_doc` line per parameter."""
        pad = "  " * indent
        lines = []
        for param in cls._spec.params.values():
            lines.append(param.format_yaml_doc(indent))
        for name, section in cls._spec.sections.items():
            lines.append(f"{pad}{name}:")
            lines.append(section.format_yaml_doc(indent + 1))
        return "\n".join(lines)
