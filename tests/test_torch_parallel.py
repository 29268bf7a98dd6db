"""The port's multi-device functions (kateth_tpu_torch/parallel) on a gloo
group of CPU processes, one spawn per world size (2 and 4), every check
inside it.

At N = 32 the world of 2 and of 4 both give B = N / world > world, so the
all_to_all reorders of the sharded NTT are seen.  The sharded NTTs are held
bit for bit against the port's single-device ntt_mont (which
tests/test_torch_ntt.py holds against the JAX package), the sharded MSM in
affine against curves.msm.msm (its additions run in another order), and
the batch-sharded commits bit for bit against the same commit of the whole
batch.  The JAX package's tests/test_parallel.py holds its own sharded
functions to its single-device ones.  This module imports no JAX, so the
spawned processes start quickly.
"""

import random

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from kateth_tpu_torch import host, ntt
from kateth_tpu_torch.curves import comb, g1, msm
from kateth_tpu_torch.fields import limbs as L
from kateth_tpu_torch.fields.specs import FP, FR
from kateth_tpu_torch.parallel import (
    distributed_init,
    four_step_order,
    replicate,
    shard_batch,
    sharded_commit,
    sharded_commit_comb,
    sharded_msm,
    sharded_ntt,
    sharded_ntt_from_brp,
    sharded_ntt_natural,
)
from kateth_tpu_torch.parallel import ntt as pntt

rng = random.Random(0x706172)
N = 32
WINDOW = 4
H = 4


def _check(what: str, ok: bool) -> None:
    if not ok:
        raise AssertionError(f"rank {dist.get_rank()}: {what}")


def _affine_equal(p, q) -> bool:
    """X1 Z2 = X2 Z1 and Y1 Z2 = Y2 Z1: the same affine point (neither is
    the identity here)."""
    (X1, Y1, Z1), (X2, Y2, Z2) = p, q
    lhs = L.mont_mul(FP, torch.stack([X1, Y1]), Z2)
    rhs = L.mont_mul(FP, torch.stack([X2, Y2]), Z1)
    return torch.equal(lhs, rhs) and not bool(L.is_zero(Z1).any())


def _worker(rank: int, world: int, init: str, data: dict) -> None:
    torch.set_num_threads(1)
    distributed_init(init_method=init, rank=rank, world_size=world, device="cpu")
    try:
        x, ref = data["x"], data["ntt"]
        blk = slice(rank * N // world, (rank + 1) * N // world)
        for inverse in (False, True):
            shard = pntt.input_shard(x)
            _check("sharded_ntt", torch.equal(sharded_ntt(shard, inverse), ref[inverse][..., blk, :]))
            _check("sharded_ntt_natural",
                   torch.equal(sharded_ntt_natural(shard, inverse), ref[inverse][..., blk, :]))
            # the four-step order, put back in natural order on the host
            parts = [torch.empty_like(shard) for _ in range(world)]
            dist.all_gather(parts, sharded_ntt(shard, inverse, natural_output=False))
            flat = torch.cat(parts, dim=-2)
            order = torch.as_tensor(four_step_order(world, N // world))
            _check("the four-step order", torch.equal(flat[..., order, :], ref[inverse]))
            got = sharded_ntt_from_brp(shard_batch(x.movedim(-2, 0)).movedim(0, -2), inverse)
            _check("sharded_ntt_from_brp", torch.equal(got, ref[("brp", inverse)][..., blk, :]))

        points, batch = data["points"], data["batch"]
        got = sharded_msm(shard_batch(points), shard_batch(batch[0]), window=WINDOW)
        _check("sharded_msm", _affine_equal(got, tuple(c[0] for c in data["commit"])))
        got = sharded_commit(replicate(points), shard_batch(batch), window=WINDOW)
        _check("sharded_commit", all(torch.equal(a, b) for a, b in zip(got, shard_batch(data["commit"]))))
        got = sharded_commit_comb(data["table"], shard_batch(batch), H)
        _check("sharded_commit_comb", all(torch.equal(a, b) for a, b in zip(got, shard_batch(data["comb"]))))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def data():
    """Inputs, and the single-device results each rank is held to."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    x = torch.as_tensor(np.stack([[FR.from_int(rng.randrange(host.R)) for _ in range(N)]
                                  for _ in range(3)]))  # (3, N, 16) Montgomery
    pts = [host.jac_mul_raw(host.FP_OPS, host.G1_GEN, rng.randrange(1, host.R)) for _ in range(N)]
    points = tuple(torch.as_tensor(c) for c in g1.from_ints(pts))
    scalars = torch.as_tensor(np.stack([FR.from_int(rng.randrange(host.R), mont=False)
                                        for _ in range(N)]))
    # (4, N, 16): splits over 2 and 4; row 0 is also the sharded MSM's
    batch = torch.stack([scalars, scalars.flip(0)] * 2)
    table = comb.build_table(points, H)
    out = {
        "x": x,
        "ntt": {inv: ntt.ntt_mont(x, inverse=inv) for inv in (False, True)},
        "points": points,
        "batch": batch,
        "commit": msm.msm(points, batch, c=WINDOW),
        "table": table,
        "comb": comb.commit(table, batch, H, N),
    }
    for inv in (False, True):
        out["ntt"][("brp", inv)] = ntt.ntt_mont(x, inverse=inv, bitrev_input=True)
    torch.set_num_threads(prev)
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ops_match_single_device(world, data, tmp_path):
    mp.spawn(_worker, args=(world, f"file://{tmp_path}/store", data), nprocs=world, join=True)


def test_shard_layouts_and_errors(monkeypatch):
    """Without a group: the shapes each rank is given, and the errors."""
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    x = torch.arange(32 * 16).reshape(32, 16)
    assert torch.equal(shard_batch(x), x[8:16])
    assert torch.equal(pntt.input_shard(x), x.reshape(4, 8, 16)[:, 2:4].reshape(8, 16))
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(x[:30])
    with pytest.raises(ValueError, match="world size squared"):
        pntt.input_shard(x[:8])
    assert four_step_order(2, 4).tolist() == [0, 4, 1, 5, 2, 6, 3, 7]

