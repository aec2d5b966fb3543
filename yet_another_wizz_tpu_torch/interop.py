"""Build this package's engine inputs from the JAX package's host state.

The JAX package's ``TileSet`` and ``TilePairs`` are plain numpy containers
on the host. Passing their fields here as numpy arrays gives the port the
same tile lanes and pair lists byte for byte, so both engines can be held
against each other on identical inputs. Nothing here imports either JAX
package module: callers pass arrays.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.ops.linkage import TilePairs
from yet_another_wizz_tpu_torch.ops.tiles import TileSet

if TYPE_CHECKING:
    from numpy.typing import NDArray

__all__ = [
    "tilepairs_from_arrays",
    "tileset_from_arrays",
]


def tileset_from_arrays(
    *,
    lane_data: NDArray,
    tile_patch: NDArray,
    tile_center: NDArray,
    tile_radius: NDArray,
    patch_tile_start: NDArray,
    patch_tile_stop: NDArray,
    sum_weights: NDArray,
    tile_zmin: NDArray,
    tile_zmax: NDArray,
    num_bins: int,
    num_points: int,
    sum_kappa: NDArray | None = None,
) -> TileSet:
    """A :class:`TileSet` from the fields of the JAX package's ``TileSet``
    dataclass. ``lane_data`` must be the float32 ``(num_tiles, 8, T)``
    lanes; the tile size is read from its shape."""
    lane_data = np.ascontiguousarray(lane_data, dtype=np.float32)
    if lane_data.ndim != 3 or lane_data.shape[1] != 8:
        raise ValueError("'lane_data' must have shape (num_tiles, 8, T)")
    return TileSet(
        lane_data=lane_data,
        tile_patch=np.asarray(tile_patch),
        tile_center=np.asarray(tile_center, dtype=np.float64),
        tile_radius=np.asarray(tile_radius, dtype=np.float64),
        patch_tile_start=np.asarray(patch_tile_start),
        patch_tile_stop=np.asarray(patch_tile_stop),
        sum_weights=np.asarray(sum_weights, dtype=np.float64),
        sum_kappa=None if sum_kappa is None else np.asarray(sum_kappa),
        tile_zmin=np.asarray(tile_zmin, dtype=np.int32),
        tile_zmax=np.asarray(tile_zmax, dtype=np.int32),
        num_bins=int(num_bins),
        num_points=int(num_points),
        tile_size=lane_data.shape[2],
    )


def tilepairs_from_arrays(
    tile1: NDArray, tile2: NDArray, slot: NDArray, slot_patches: NDArray
) -> TilePairs:
    """A :class:`TilePairs` from the JAX package's slot-sorted pair list."""
    return TilePairs(
        tile1=np.ascontiguousarray(tile1, dtype=np.int32),
        tile2=np.ascontiguousarray(tile2, dtype=np.int32),
        slot=np.ascontiguousarray(slot, dtype=np.int32),
        slot_patches=np.asarray(slot_patches),
    )
