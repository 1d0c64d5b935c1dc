"""Parallelism layer: meshes, shardings, collectives (port of
``ray_tpu.parallel``).

The JAX package's dense collectives happen inside compiled XLA programs;
the port's happen inside DTensor ops over a ``torch.distributed`` process
group (``mesh``, ``sharding``). Cross-host data movement outside a step
rides the object store (``collectives``). The GPipe schedule
(``pipeline``) runs over the ``stage`` axis through ``shard_map_compat``.
``cpu_mesh_devices``, XLA's virtual CPU devices, is not ported: a gloo
group of processes takes their place.
"""

from ray_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params
from ray_tpu_torch.parallel.mesh import (
    MeshSpec,
    DATA,
    FSDP,
    TENSOR,
    SEQUENCE,
    EXPERT,
    STAGE,
    make_mesh,
)
from ray_tpu_torch.parallel.sharding import (
    ShardingRules,
    constrain,
    constrain_tree,
    ddp_rules,
    fsdp_rules,
    logical_to_sharding,
    match_partition_rules,
    named_tree_map,
    shard_params_fsdp,
    tp_rules,
    tree_path_names,
)
from ray_tpu_torch.parallel.collectives import CollectiveGroup

__all__ = [
    "pipeline_apply",
    "stack_stage_params",
    "MeshSpec",
    "DATA",
    "FSDP",
    "TENSOR",
    "SEQUENCE",
    "EXPERT",
    "STAGE",
    "make_mesh",
    "ShardingRules",
    "constrain",
    "constrain_tree",
    "ddp_rules",
    "fsdp_rules",
    "logical_to_sharding",
    "match_partition_rules",
    "named_tree_map",
    "shard_params_fsdp",
    "tp_rules",
    "tree_path_names",
    "CollectiveGroup",
]
