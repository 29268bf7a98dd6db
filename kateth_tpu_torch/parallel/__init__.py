"""Multi-GPU scale-out over torch.distributed: one process per device.

Every function is SPMD: each rank calls it with its own shard and gets its
own part of the result, and the collectives run over a process group (the
default group unless the caller passes one).  The point-sharded MSM sums
its shards with one all_gather; the batched commits split the batch and
replicate the table, with no communication; the four-step NTT exchanges
its data with all_to_all.
"""

from .mesh import distributed_init, local_device, replicate, shard_batch
from .msm import sharded_commit, sharded_commit_comb, sharded_msm
from .ntt import four_step_order, sharded_ntt, sharded_ntt_from_brp, sharded_ntt_natural

__all__ = [
    "distributed_init",
    "local_device",
    "shard_batch",
    "replicate",
    "sharded_msm",
    "sharded_commit",
    "sharded_commit_comb",
    "sharded_ntt",
    "sharded_ntt_from_brp",
    "sharded_ntt_natural",
    "four_step_order",
]
