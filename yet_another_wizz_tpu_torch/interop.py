"""Build this package's engine inputs from the JAX package's host state.

The JAX package's ``TileSet``, ``TilePairs`` and ``AngularEdges`` (with
its ``DirectEdges``) are plain numpy containers on the host. Passing their
fields here as numpy arrays gives the port the same tile lanes, pair lists
and edge tables byte for byte, so both engines can be held against each
other on identical inputs. Nothing here imports either JAX package module:
callers pass arrays.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.ops.linkage import TilePairs
from yet_another_wizz_tpu_torch.ops.thresholds import AngularEdges, DirectEdges
from yet_another_wizz_tpu_torch.ops.tiles import TileSet

if TYPE_CHECKING:
    from numpy.typing import NDArray

__all__ = [
    "angular_edges_from_arrays",
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


def angular_edges_from_arrays(
    *,
    chord2_table: NDArray,
    edges: NDArray,
    scale_maps: NDArray,
    max_angle: float,
    direct: dict | None = None,
) -> AngularEdges:
    """An :class:`AngularEdges` from the fields of the JAX package's
    ``AngularEdges`` dataclass. ``direct`` holds the fields of its
    ``DirectEdges`` (``chord2_table``, ``edges``, ``scale_maps``,
    ``gtable``, ``num_sub``, ``num_below``, ``num_above``), or is None for
    cumulative counting."""
    if direct is not None:
        direct = DirectEdges(
            chord2_table=np.asarray(direct["chord2_table"], np.float32),
            edges=np.asarray(direct["edges"], np.float64),
            scale_maps=np.asarray(direct["scale_maps"], np.float64),
            gtable=np.asarray(direct["gtable"], np.float32),
            num_sub=int(direct["num_sub"]),
            num_below=int(direct["num_below"]),
            num_above=int(direct["num_above"]),
        )
    return AngularEdges(
        chord2_table=np.asarray(chord2_table, np.float32),
        edges=np.asarray(edges, np.float64),
        scale_maps=np.asarray(scale_maps, np.float64),
        max_angle=float(max_angle),
        direct=direct,
    )
