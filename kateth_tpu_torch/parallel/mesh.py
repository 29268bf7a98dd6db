"""Process groups and shards: one process per device, ranked 0 .. world - 1.

`distributed_init` joins the process group (NCCL unless the caller names
gloo or the CPU); `local_device` is the device a rank runs on;
`shard_batch` cuts a tensor's leading axis into the world's equal shards
and keeps this rank's; `replicate` gives every rank the whole tensor on
its device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def distributed_init(backend: str | None = None, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     device=None, store=None):
    """Join the default process group once and return it.  The backend is
    NCCL unless the caller names one or names device="cpu" (then gloo).
    The rendezvous is `init_method` (for example tcp://localhost:<port> or
    file://<path>) or a torch.distributed `store`; with neither, torch
    reads MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE from the
    environment."""
    if dist.is_initialized():
        return dist.group.WORLD
    if backend is None:
        backend = "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"
    kw = {k: v for k, v in (("init_method", init_method), ("store", store), ("rank", rank),
                            ("world_size", world_size)) if v is not None}
    dist.init_process_group(backend, **kw)
    return dist.group.WORLD


def local_device(rank: int | None = None, device=None) -> torch.device:
    """cuda:<local rank> (the rank modulo the visible devices), or the
    device the caller names; raises when there is no CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def _map(fn, x):
    return type(x)(fn(a) for a in x) if isinstance(x, (tuple, list)) else fn(x)


def shard_batch(x, device=None, group=None):
    """This rank's shard of the leading axis of x (a tensor, or a tuple of
    tensors such as a point), on `device`; the axis must divide evenly."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)

    def one(a):
        if a.shape[0] % world:
            raise ValueError(f"a leading axis of {a.shape[0]} does not split over {world} ranks")
        return a.chunk(world)[rank].to(device or a.device)

    return _map(one, x)


def replicate(x, device=None):
    """The whole of x (a tensor or a tuple of tensors) on `device`."""
    return _map(lambda a: a.to(device or a.device), x)
