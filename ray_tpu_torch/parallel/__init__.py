"""ray_tpu_torch.parallel — mesh, sharding rules and process bootstrap.

Port of `ray_tpu.parallel`: parallelism is a `DeviceMesh` with named
axes (dcn / dp / fsdp / tp / sp / ep / pp) plus logical-axis sharding
rules; the train step runs the collectives the specs imply over NCCL on
the card (gloo on the CPU). `with_logical_constraint` and
`named_sharding` are GSPMD placements with no counterpart outside a
compiler: the tp axis runs as explicit Megatron layers instead
(`tensor_parallel`: `TPGroup`, f and g, the vocab-parallel ends and
`local_heads`), passed down to the model as its ``tp=`` argument, and
the sp axis as explicit rotations and all-to-alls (`sequence_parallel`:
`SPGroup`), passed down as ``sp=``; the pp axis runs the GPipe schedule
with point-to-point hand-offs (`pipeline`), and the ep axis reuses the
tp layer's f and g over its own group (`models.moe`). Inside a train
step a model reads the batch split from `data_parallel`.
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
from ray_tpu_torch.parallel.pipeline import (make_pipelined_fn,
                                             stack_stage_params)
from ray_tpu_torch.parallel.sequence_parallel import SPGroup, sp_group
from ray_tpu_torch.parallel.tensor_parallel import (
    TPGroup,
    copy_to_tp,
    gather_logits,
    local_heads,
    reduce_from_tp,
    tp_group,
    vocab_cross_entropy,
    vocab_embed,
)

__all__ = [
    "AXIS_ORDER",
    "DEFAULT_RULES",
    "DistributedInfo",
    "LogicalAxisRules",
    "MeshSpec",
    "SPGroup",
    "TPGroup",
    "auto_mesh",
    "copy_to_tp",
    "create_hybrid_mesh",
    "create_mesh",
    "distributed_info",
    "gather_logits",
    "initialize_distributed",
    "local_heads",
    "local_mesh",
    "logical_to_mesh",
    "make_pipelined_fn",
    "mesh_shape_for",
    "prune_rules_for_mesh",
    "reduce_from_tp",
    "shard_pytree",
    "sp_group",
    "spec_for",
    "stack_stage_params",
    "tp_group",
    "vocab_cross_entropy",
    "vocab_embed",
]
