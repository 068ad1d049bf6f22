"""Multi-device layer of the torch port (counterpart of
``merklekv_tpu/parallel/``): meshes over the host's devices, the sharded
Merkle build and diff, the sharded serving-tree state, and the
multi-process keyspace mesh over ``torch.distributed`` (``multihost``)."""

from merklekv_tpu_torch.parallel.mesh import Mesh, make_mesh
from merklekv_tpu_torch.parallel.sharded_merkle import (
    make_anti_entropy_step,
    sharded_anti_entropy_step,
    sharded_divergence,
    sharded_divergence_2d,
    sharded_tree_root,
)
from merklekv_tpu_torch.parallel.sharded_state import (
    ShardedDeviceMerkleState,
    resolve_shard_count,
)
from merklekv_tpu_torch.parallel import multihost

__all__ = [
    "Mesh",
    "make_mesh",
    "multihost",
    "sharded_tree_root",
    "sharded_divergence",
    "sharded_divergence_2d",
    "sharded_anti_entropy_step",
    "make_anti_entropy_step",
    "ShardedDeviceMerkleState",
    "resolve_shard_count",
]
