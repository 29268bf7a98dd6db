"""Distributed MSM and commitments.

* Point sharding: the points and scalars of one MSM are split over the
  ranks; each rank runs the windowed MSM (curves/msm.py) on its shard, and
  the shards' sums meet in one all_gather of the world's projective points
  and a halving sum, the same on every rank.
* Blob sharding: a batch of commitments splits its batch over the ranks,
  the point table (or the comb table) is replicated; nothing is exchanged.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..curves import comb
from ..curves import msm as msm_mod
from ..curves import ops

F1 = ops.FP_FIELD


def _allreduce_point(p, group=None):
    """The sum of every rank's point: all_gather, then a halving sum."""
    coords = torch.stack(p)  # the three coordinates in one collective
    parts = [torch.empty_like(coords) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, coords, group=group)
    return msm_mod.halving_sum(F1, torch.stack(parts).unbind(1), axis=0)


def sharded_msm(points, scalars_plain: torch.Tensor, window: int = 8, group=None):
    """One MSM, this rank holding a shard of it: points a projective tuple
    of (n, 24), scalars (*batch, n, 16) plain.  Returns the whole MSM, the
    same projective point on every rank."""
    return _allreduce_point(msm_mod.msm(points, scalars_plain, c=window), group)


def sharded_commit(points, scalars_batch: torch.Tensor, window: int = 8):
    """Commitments of this rank's shard of a batch, (B/world, N, 16)
    plain, with the whole (replicated) point table, by the windowed MSM."""
    return msm_mod.msm(points, scalars_batch, c=window)


def sharded_commit_comb(table, scalars_batch: torch.Tensor, h: int):
    """Fixed-base comb commitments (curves/comb.py, kernel K8) of this
    rank's shard of a batch, with its own copy of the comb table."""
    return comb.commit(table, scalars_batch, h, scalars_batch.shape[-2])
