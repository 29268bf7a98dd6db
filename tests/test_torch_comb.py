"""The port's fixed-base comb commit (curves/comb.py) on CPU at n = 8,
h = 4: column digits exactly against the jitted JAX function and the
affine table exactly against the oracle, kernel K8's plain chain sum exactly against the same rows
summed by the JAX package's complete addition, and the commitment against
the oracle's MSM in affine (the port sums chains of g rows as the kernel
does, the JAX CPU path halves over all N, so the projective
representatives differ)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kateth_tpu.curves import comb as jcomb
from kateth_tpu.curves import g1 as jg1
from kateth_tpu.curves import ops as jops
from kateth_tpu.oracle import curve as oc
from kateth_tpu.oracle import field as of
from kateth_tpu.oracle.kzg import OracleSetup
from kateth_tpu_torch.curves import comb, cuda_msm, g1, msm, ops
from kateth_tpu_torch.fields import limbs as L
from kateth_tpu_torch.fields.specs import FP
from kateth_tpu_torch.kzg import KzgError

N = 8
H = 4
D_COLS = comb.comb_dims(H)
F1 = ops.FP_FIELD
rng = random.Random(0x636F6D62)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def osetup():
    return OracleSetup.generate_insecure(N, g2_len=2)


@pytest.fixture(scope="module")
def points(osetup):
    return tuple(torch.as_tensor(c) for c in g1.from_ints(osetup.g1_lagrange_brp))


@pytest.fixture(scope="module")
def table(points):
    return comb.build_table(points, H)


def planes(vals) -> np.ndarray:
    return np.stack([L.int_to_digits(v, 16) for v in vals])


def test_column_digits_matches_jax():
    vals = [rng.randrange(of.R) for _ in range(5)] + [of.R - 1, 0]
    sc = planes(vals)
    want = jcomb.column_digits(jnp.asarray(sc.astype(np.uint32)), H, D_COLS)
    got = comb.column_digits(torch.as_tensor(sc), H, D_COLS)
    assert got.shape == (D_COLS, len(vals))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_build_table_matches_oracle(osetup, table):
    """Every affine row, exactly: T[i][j] = sum_k j_k 2^(k d) P_i by the
    oracle, and row j = 0 of each point is (0, 1).  (The JAX build_table's
    XLA compile takes well over a minute on this CPU; affine rows
    are canonical, so the oracle pins the same digits.)"""
    tx, ty = (c.numpy() for c in table)
    assert tx.shape == ty.shape == (N << H, FP.n_digits)
    for i, p in enumerate(osetup.g1_lagrange_brp):
        basis = [oc.g1_mul(p, 1 << (k * D_COLS)) for k in range(H)]
        for jj in range(1 << H):
            r = (i << H) + jj
            if jj == 0:
                assert (tx[r] == 0).all() and (ty[r] == FP.one_mont).all()
                continue
            want = oc.g1_infinity()
            for k in range(H):
                if (jj >> k) & 1:
                    want = oc.g1_add(want, basis[k])
            wx, wy = oc.g1_to_affine(want)
            assert (FP.to_int(tx[r]), FP.to_int(ty[r])) == (wx, wy), (i, jj)


def test_build_table_rejects_an_identity_point(points):
    bad = tuple(torch.cat([c[:1], i[None]]) for c, i in zip(points, ops.identity(F1)))
    with pytest.raises(KzgError, match="identity"):
        comb.build_table(bad, 2)


def test_comb_chain_sum_plain_matches_jax_padd():
    """K8's plain version over chains of g = 4 rows (identity rows, a
    repeated point: the doubling case) against jops.padd over the same
    rows with Z = flag ? 1 : 0, bit for bit."""
    g, B, n = 4, 2, 8
    base = [oc.g1_mul(oc.G1_GEN, rng.randrange(1, of.R)) for _ in range(3)]
    aff = [oc.g1_to_affine(p) for p in (base + base[:1] * 5)]  # rows 3..7 repeat
    flags = np.array([[1, 0, 1, 1, 1, 1, 0, 1], [0, 0, 0, 0, 1, 1, 1, 1]], dtype=bool)
    one = np.asarray(FP.one_mont)
    x = np.stack([np.stack([FP.from_int(a[0]) if f else np.zeros(24, np.int64)
                            for a, f in zip(aff, row)]) for row in flags])
    y = np.stack([np.stack([FP.from_int(a[1]) if f else one for a, f in zip(aff, row)])
                  for row in flags])
    got = cuda_msm.comb_chain_sum(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(flags), g)

    def jax_chains(x, y, z):  # chain c holds rows c g .. c g + g - 1
        acc = jops.identity(jops.FP_FIELD, (B, n // g))
        for k in range(g):
            acc = jops.padd(jops.FP_FIELD, acc, tuple(c.reshape(B, n // g, g, -1)[:, :, k] for c in (x, y, z)))
        return acc

    z = np.where(flags[..., None], one, 0)
    want = jax.jit(jax_chains)(*(jnp.asarray(a.astype(np.uint32)) for a in (x, y, z)))
    for gc, wc in zip(got, want):
        assert gc.shape == (B, n // g, FP.n_digits)
        assert np.array_equal(gc.numpy(), np.asarray(wc).astype(np.int64))
    # lane 1, chain 0 holds only identity rows
    assert ops.is_identity(F1, got).tolist() == [[False, False], [True, False]]


def test_commit_matches_oracle(osetup, table):
    """Three lanes, one with a zero scalar, another all zero (the
    identity), against the oracle's MSM, in affine."""
    vals = [[rng.randrange(of.R) for _ in range(N)] for _ in range(3)]
    vals[1][0] = 0
    vals[2] = [0] * N
    sc = torch.as_tensor(np.stack([planes(row) for row in vals]))
    got = comb.commit(table, sc, H, N)
    assert ops.is_identity(F1, got).tolist() == [False, False, True]
    for b in range(2):
        want = jg1.to_oracle(tuple(c[b][None].numpy() for c in got))[0]
        assert oc.g1_eq(want, oc.g1_msm(osetup.g1_lagrange_brp, vals[b]))


def test_commit_batched_columns_match_per_column_loop(table):
    """comb.commit gathers the rows of all d columns at once, sums their
    chains in one K8 call and one halving sum, then combines the columns;
    a loop over the columns, MSB first, with a K8 call, a halving sum, a
    doubling and an addition each, gives the same projective digits.  Four
    blobs: random scalars, three zero scalars (clear flags), all zero
    (every chain the identity) and small scalars (only the low columns
    hold points)."""
    vals = [[rng.randrange(of.R) for _ in range(N)] for _ in range(4)]
    vals[1][:3] = [0, 0, 0]
    vals[2] = [0] * N
    vals[3] = list(range(1, N + 1))
    sc = torch.as_tensor(np.stack([planes(row) for row in vals]))
    got = comb.commit(table, sc, H, N)

    g = min(cuda_msm.COMB_CHAIN, N)
    cols = comb.column_digits(sc, H, D_COLS)  # (d, 4, N)
    assert (cols == 0).any() and (cols != 0).any()
    assert (cols.reshape(D_COLS, 4, N // g, g) == 0).all(-1).any()  # an all-identity chain
    base = torch.arange(N) << H
    want = ops.identity(F1, (4,))
    for t in range(D_COLS - 1, -1, -1):
        idx = cols[t] + base
        chains = cuda_msm.comb_chain_sum(table[0][idx], table[1][idx], cols[t] != 0, g)
        s = msm.halving_sum(F1, chains, axis=1)
        want = ops.padd(F1, ops.pdouble(F1, want), s)
    for gc, wc in zip(got, want):
        assert torch.equal(gc, wc)
