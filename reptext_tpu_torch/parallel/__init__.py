"""Parallelism of the port: SP groups and the SP attention and forward; the
(dp, tp) mesh and tensor parallelism's rules and layers."""

from reptext_tpu_torch.parallel.group import DistSPGroup, SPGroup, decide_on_rank0, make_sp_group
from reptext_tpu_torch.parallel.mesh import LocalMesh, Mesh, make_mesh
from reptext_tpu_torch.parallel.partition import param_shardings, shard_batch, shard_module
from reptext_tpu_torch.parallel.sequence import (
    joint_ring_attention_local,
    joint_ulysses_attention_local,
    sequence_parallel_forward,
    sequence_sharded_attention,
    sp_context,
)

__all__ = ["DistSPGroup", "LocalMesh", "Mesh", "SPGroup", "decide_on_rank0", "make_mesh",
           "make_sp_group", "param_shardings", "shard_batch", "shard_module",
           "joint_ring_attention_local", "joint_ulysses_attention_local",
           "sequence_parallel_forward", "sequence_sharded_attention", "sp_context"]
