"""The port's windowed Pippenger (curves/msm.py) and the prefix scan of
kernel K7 (curves/cuda_msm.py) on CPU: window digits exactly against the
jitted JAX function, K7's plain within-chain sums exactly against the JAX
package's complete addition, the two-level scan against the JAX
Hillis-Steele msm.prefix_scan as projective points (peq: the two scans add
in other orders), and the MSM against the oracle (the JAX msm's XLA compile
takes minutes here)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kateth_tpu.curves import g1 as jg1
from kateth_tpu.curves import msm as jmsm
from kateth_tpu.curves import ops as jops
from kateth_tpu.oracle import curve as oc
from kateth_tpu.oracle import field as of
from kateth_tpu_torch.curves import cuda_msm, g1, msm, ops
from kateth_tpu_torch.fields import limbs as L

F1 = ops.FP_FIELD
rng = random.Random(0x6D736D)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def planes(vals) -> np.ndarray:
    return np.stack([L.int_to_digits(v, 16) for v in vals])


def j(x):
    return tuple(jnp.asarray(np.asarray(a).astype(np.uint32)) for a in x)


def random_points(n):
    """n points: random multiples of G, with G repeated and the identity."""
    pts = [oc.g1_mul(oc.G1_GEN, rng.randrange(1, of.R)) for _ in range(n - 3)]
    return pts + [oc.G1_GEN, oc.G1_GEN, oc.g1_infinity()]


@pytest.mark.parametrize("c", [8, 5])
def test_window_digits_matches_jax(c):
    sc = planes([rng.randrange(of.R) for _ in range(4)] + [of.R - 1, 0])
    want = jmsm.window_digits(jnp.asarray(sc.astype(np.uint32)), c)
    got = msm.window_digits(torch.as_tensor(sc), c)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_chain_prefix_plain_matches_jax_padd():
    """K7's plain version, exactly: within-chain running sums of g = 8."""
    P = tuple(np.stack([c, c[::-1]]) for c in g1.from_ints(random_points(16)))  # (2, 16, 24)

    def jax_prefix(p):
        chains = tuple(c.reshape(2, 2, 8, 24) for c in p)
        acc = jops.identity(jops.FP_FIELD, (2, 2))
        outs = []
        for k in range(8):
            acc = jops.padd(jops.FP_FIELD, acc, tuple(c[:, :, k] for c in chains))
            outs.append(acc)
        return tuple(jnp.stack([o[i] for o in outs], axis=2).reshape(2, 16, 24) for i in range(3))

    want = jax.jit(jax_prefix)(j(P))
    got = cuda_msm.chain_prefix(tuple(torch.as_tensor(c) for c in P), 8)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_two_level_scan_matches_jax_prefix_scan():
    """The two-level scan (K7's plain version, chain-total scan, offset
    add) at every index against JAX msm.prefix_scan over 32 points, equal
    as points."""
    P = tuple(np.stack([c, c[::-1]]) for c in g1.from_ints(random_points(32)))  # (2, 32, 24)
    got = cuda_msm.prefix_scan_kernel(tuple(torch.as_tensor(c) for c in P),
                                      torch.arange(32).expand(2, 32))

    def jax_same(p, q):
        return jops.peq(jops.FP_FIELD, jmsm.prefix_scan(jops.FP_FIELD, p, axis=1), q)

    same = jax.jit(jax_same)(j(P), j(c.numpy() for c in got))
    assert np.asarray(same).shape == (2, 32) and np.asarray(same).all()


def test_two_level_scan_at_indices_is_the_full_scan_gathered():
    """prefix_scan_kernel at some indices (repeated, unordered, the ends)
    of 2 rows of 16 points: the sums of the two-level scan run unsliced
    over every point (K7's plain version, one Hillis-Steele scan of all
    the chain totals, the offset add on every lane) at those indices, bit
    for bit."""
    P = tuple(torch.as_tensor(np.stack([c, c[::-1]])) for c in g1.from_ints(random_points(16)))
    idx = torch.tensor([[15, 0, 7, 8, 8, 3], [1, 9, 9, 15, 2, 0]])
    within = tuple(cuda_msm._chains(c, 8) for c in cuda_msm.chain_prefix_plain(P, 8))
    incl = msm.prefix_scan(F1, tuple(w[..., 7, :] for w in within), axis=-2)
    excl = tuple(torch.cat([i.expand(2, 1, 24), t[:, :-1]], dim=1)
                 for i, t in zip(ops.identity(F1, ()), incl))
    full = ops.padd(F1, within, tuple(e[..., None, :].expand_as(w) for e, w in zip(excl, within)))
    got = cuda_msm.prefix_scan_kernel(P, idx)
    for g, f in zip(got, full):
        assert torch.equal(g, torch.take_along_dim(f.reshape(2, 16, 24), idx[..., None], dim=-2))


def test_scalar_mul_const_matches_oracle():
    P = tuple(torch.as_tensor(c) for c in g1.from_ints([oc.G1_GEN]))
    for k in (0, 1, 2, 255):
        got = jg1.to_oracle(tuple(c.numpy() for c in msm.scalar_mul_const(F1, P, k)))[0]
        assert oc.g1_eq(got, oc.g1_mul(oc.G1_GEN, k)), k


def test_msm_matches_oracle():
    """Batch 2 over 8 points with a zero scalar, scalars with repeated
    window digits, and one lane of small scalars, in affine."""
    pts = random_points(8)
    P = tuple(torch.as_tensor(c) for c in g1.from_ints(pts))
    v = rng.randrange(of.R)
    vals = [
        [rng.randrange(of.R) for _ in range(3)] + [0, v, v, int("ab" * 31, 16), 7],
        [1, 2, 255, 256, 0, 0, of.R - 1, v],
    ]
    got = msm.msm(P, torch.as_tensor(np.stack([planes(row) for row in vals])), c=8)
    for b in range(2):
        lane = jg1.to_oracle(tuple(c[b][None].numpy() for c in got))[0]
        assert oc.g1_eq(lane, oc.g1_msm(pts, vals[b])), b
