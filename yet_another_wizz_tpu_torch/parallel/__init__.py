"""Multi-device and multi-process execution: meshes, sharded pair
counting and process coordination.

The reference scales out with an MPI task farm over patch pairs
(yaw/utils/parallel.py:38-484). Like the JAX package, the port shards the
flat tile-pair list over a mesh of devices (:mod:`.sharded`): every shard
runs the single-device engine on its part of the list and the partial
counts are summed in shard order. Host coordination (root-only I/O,
broadcast of host values) runs over ``torch.distributed`` with gloo
(:mod:`.distributed`).
"""

from yet_another_wizz_tpu_torch.parallel.distributed import (
    barrier,
    broadcast,
    broadcasted,
    initialize,
    num_processes,
    on_root,
    process_index,
    run_on_root,
)
from yet_another_wizz_tpu_torch.parallel.sharded import (
    Mesh,
    auto_mesh,
    count_pairs_sharded,
    default_mesh,
)

__all__ = [
    "auto_mesh",
    "barrier",
    "broadcast",
    "broadcasted",
    "count_pairs_sharded",
    "default_mesh",
    "initialize",
    "num_processes",
    "on_root",
    "process_index",
    "run_on_root",
]
