"""Sequence parallelism of the port: SP groups and the SP attention and forward."""

from reptext_tpu_torch.parallel.group import DistSPGroup, SPGroup, decide_on_rank0, make_sp_group
from reptext_tpu_torch.parallel.sequence import (
    joint_ring_attention_local,
    joint_ulysses_attention_local,
    sequence_parallel_forward,
    sequence_sharded_attention,
    sp_context,
)

__all__ = ["DistSPGroup", "SPGroup", "decide_on_rank0", "make_sp_group",
           "joint_ring_attention_local", "joint_ulysses_attention_local",
           "sequence_parallel_forward", "sequence_sharded_attention", "sp_context"]
