"""Per-patch summary statistics.

Ported from the JAX package's ``catalog/patch.py`` as far as the in-memory
catalog needs it: :class:`Metadata` (record count, sum of weights, cap
center and radius). The on-disk patch cache is not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.coordinates import AngularCoordinates, AngularDistances

if TYPE_CHECKING:
    from numpy.typing import NDArray
    from typing_extensions import Self

__all__ = [
    "Metadata",
]


class Metadata:
    """Summary statistics of one patch: size, weight, bounding cap."""

    __slots__ = ("num_records", "sum_weights", "center", "radius")

    def __init__(
        self,
        *,
        num_records: int,
        sum_weights: float,
        center: AngularCoordinates,
        radius: AngularDistances,
    ) -> None:
        self.num_records = num_records
        self.sum_weights = sum_weights
        self.center = center
        self.radius = radius

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(num_records={self.num_records}, "
            f"sum_weights={self.sum_weights}, center={self.center.data[0]}, "
            f"radius={self.radius.data[0]})"
        )

    @classmethod
    def compute(
        cls: type[Self],
        coords: AngularCoordinates,
        *,
        weights: NDArray | None = None,
        center: AngularCoordinates | None = None,
    ) -> Self:
        """Compute metadata from patch coordinates (optionally around an
        externally fixed center)."""
        num_records = len(coords)
        sum_weights = (
            float(num_records) if weights is None else float(np.sum(weights))
        )
        if center is not None:
            if len(center) != 1:
                raise ValueError("'center' must be one single coordinate")
            center = center.copy()
        else:
            center = coords.mean(weights)
        radius = coords.distance(center).max()
        return cls(
            num_records=num_records,
            sum_weights=sum_weights,
            center=center,
            radius=radius,
        )

    @classmethod
    def from_dict(cls: type[Self], the_dict: dict) -> Self:
        """Restore an instance from :meth:`to_dict` builtins (reference
        Metadata is YamlSerialisable,
        yaw/catalog/patch.py:44)."""
        return cls(
            num_records=the_dict["num_records"],
            sum_weights=the_dict["sum_weights"],
            center=AngularCoordinates(the_dict["center"]),
            radius=AngularDistances(the_dict["radius"]),
        )

    def to_dict(self) -> dict:
        """YAML-compatible builtins describing this patch."""
        return dict(
            num_records=int(self.num_records),
            sum_weights=float(self.sum_weights),
            center=self.center.tolist()[0],
            radius=float(self.radius.tolist()[0]),
        )

    @classmethod
    def from_file(cls: type[Self], path: Path | str) -> Self:
        import yaml

        with Path(path).open() as f:
            return cls.from_dict(yaml.safe_load(f))

    def to_file(self, path: Path | str) -> None:
        import yaml

        with Path(path).open("w") as f:
            yaml.safe_dump(self.to_dict(), f)
