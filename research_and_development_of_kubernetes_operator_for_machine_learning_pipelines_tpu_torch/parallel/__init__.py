"""Meshes, sharding rules, collectives and process-group init (port of the
JAX package's ``parallel/``).

One process a rank: a replica whose ``meshShape`` spans N ranks runs N
processes in one ``torch.distributed`` world (``distributed``), each holding
its block of the weights and the KV cache (``sharding``) and joining the
collectives of its mesh axes' process groups (``mesh``, ``collectives``).
The reference's ``shard_map_compat`` is left out: it bridges two JAX
versions' ``shard_map`` and has no counterpart here, where a rank runs its
own program on its own block.
"""

from .mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_PIPE,
    AXIS_SEQ,
    AXIS_TENSOR,
    MESH_AXIS_ORDER,
    build_mesh,
    local_mesh,
)
from .sharding import (
    LOGICAL_BATCH,
    LOGICAL_EMBED,
    LOGICAL_HEADS,
    LOGICAL_KV_HEADS,
    LOGICAL_MLP,
    LOGICAL_SEQ,
    LOGICAL_VOCAB,
    PartitionRuleError,
    ShardingRules,
    TRANSFORMER_RULES,
    logical_sharding,
    logical_spec,
    match_partition_rules,
    shard_pytree,
)
from .collectives import ring_shift
from .distributed import maybe_initialize_distributed

__all__ = [
    "AXIS_DATA",
    "AXIS_EXPERT",
    "AXIS_PIPE",
    "AXIS_SEQ",
    "AXIS_TENSOR",
    "MESH_AXIS_ORDER",
    "build_mesh",
    "local_mesh",
    "ShardingRules",
    "TRANSFORMER_RULES",
    "LOGICAL_BATCH",
    "LOGICAL_EMBED",
    "LOGICAL_HEADS",
    "LOGICAL_KV_HEADS",
    "LOGICAL_MLP",
    "LOGICAL_SEQ",
    "LOGICAL_VOCAB",
    "logical_spec",
    "logical_sharding",
    "match_partition_rules",
    "PartitionRuleError",
    "shard_pytree",
    "ring_shift",
    "maybe_initialize_distributed",
]
