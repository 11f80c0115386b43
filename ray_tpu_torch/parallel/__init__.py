"""ray_tpu_torch.parallel — mesh, sharding rules and process bootstrap.

Port of `ray_tpu.parallel`: parallelism is a `DeviceMesh` with named
axes (dcn / dp / fsdp / tp / sp / ep / pp) plus logical-axis sharding
rules; the train step runs the collectives the specs imply over NCCL on
the card (gloo on the CPU). `with_logical_constraint` and
`named_sharding` are GSPMD placements with no counterpart outside a
compiler; the tensor-parallel layers that need them are ROADMAP A9.
"""

from ray_tpu_torch.parallel.bootstrap import (
    DistributedInfo,
    distributed_info,
    initialize_distributed,
)
from ray_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    MeshSpec,
    auto_mesh,
    create_hybrid_mesh,
    create_mesh,
    local_mesh,
    mesh_shape_for,
)
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    LogicalAxisRules,
    logical_to_mesh,
    prune_rules_for_mesh,
    shard_pytree,
    spec_for,
)

__all__ = [
    "AXIS_ORDER",
    "DEFAULT_RULES",
    "DistributedInfo",
    "LogicalAxisRules",
    "MeshSpec",
    "auto_mesh",
    "create_hybrid_mesh",
    "create_mesh",
    "distributed_info",
    "initialize_distributed",
    "local_mesh",
    "logical_to_mesh",
    "mesh_shape_for",
    "prune_rules_for_mesh",
    "shard_pytree",
    "spec_for",
]
