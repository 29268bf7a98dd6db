"""kateth_tpu_torch G1/G2 point arithmetic and G1 decompression vs the
JAX package (jitted, on CPU), on seeded points; exact equality of the
projective digit planes (both sides use the same complete formulas)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kateth_tpu.curves import decompress as jdec
from kateth_tpu.curves import g1 as jg1
from kateth_tpu.curves import g2 as jg2
from kateth_tpu.curves import msm as jmsm
from kateth_tpu.curves import ops as jops
from kateth_tpu.oracle import curve as oc
from kateth_tpu.oracle import field as of
from kateth_tpu_torch.curves import decompress, g1, g2, msm, ops
from kateth_tpu_torch.fields import cuda_mont
from kateth_tpu_torch.fields import limbs as L

rng = random.Random(0x63757276)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def j(x):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a).astype(np.uint32)), x)


def t(x):
    return tuple(torch.as_tensor(np.asarray(a).astype(np.int64)) for a in x)


def same(got, want):
    return all(
        np.array_equal(g.numpy(), np.asarray(w).astype(np.int64)) for g, w in zip(got, want)
    )


def g1_points():
    """Random multiples of G, G itself (doubling case), -G and infinity."""
    pts = [oc.g1_mul(oc.G1_GEN, rng.randrange(1, of.R)) for _ in range(2)]
    return pts + [oc.G1_GEN, oc.g1_neg(oc.G1_GEN), oc.g1_infinity()]


def test_from_ints_matches_oracle_converter():
    pts = g1_points()
    assert same(t(g1.from_ints(pts)), jg1.from_oracle(pts))
    q = [oc.g2_mul(oc.G2_GEN, 5), oc.g2_infinity()]
    assert same(t(g2.from_ints(q)), jg2.from_oracle(q))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_padd_pdouble_match_jax(group):
    if group == "g1":
        p = g1_points()
        q = [oc.G1_GEN, oc.g1_mul(oc.G1_GEN, 3), oc.G1_GEN, oc.G1_GEN, oc.G1_GEN]
        P, Q, F, JF = g1.from_ints(p), g1.from_ints(q), ops.FP_FIELD, jops.FP_FIELD
    else:
        p = [oc.g2_mul(oc.G2_GEN, rng.randrange(1, of.R)), oc.G2_GEN, oc.g2_infinity()]
        q = [oc.G2_GEN, oc.G2_GEN, oc.G2_GEN]
        P, Q, F, JF = g2.from_ints(p), g2.from_ints(q), ops.FP2_FIELD, jops.FP2_FIELD
    want = jax.jit(lambda a, b: (jops.padd(JF, a, b), jops.pdouble(JF, a)))(j(P), j(Q))
    got_add, got_dbl = ops.padd(F, t(P), t(Q)), ops.pdouble(F, t(P))
    assert same(got_add, want[0]) and same(got_dbl, want[1])


def test_scalar_mul_plain_matches_jax():
    """K3's plain version (256-bit ladder) against the JAX scan ladder, with
    random scalars, zero, one and the group order."""
    pts = g1_points()
    scalars = [rng.randrange(of.R), 0, 1, of.R, rng.randrange(of.R)]
    P = g1.from_ints(pts)
    sc = np.stack([L.int_to_digits(s, 16) for s in scalars])
    want = jax.jit(lambda a, s: jops.scalar_mul(jops.FP_FIELD, a, s))(j(P), j(sc))
    got = cuda_mont.g1_scalar_mul(t(P), torch.as_tensor(sc))
    assert same(got, want)
    # zero, the group order and the point at infinity give the identity
    assert ops.is_identity(ops.FP_FIELD, got).tolist() == [False, True, False, True, True]


def test_tree_sum_and_to_affine_match_jax():
    """The port's halving sum against the JAX tree_sum, in affine (the two
    add in other orders)."""
    P = g1.from_ints(g1_points()[:3])  # three points: padded to four
    want = jax.jit(
        lambda a: jops.to_affine(jops.FP_FIELD, jmsm.tree_sum(jops.FP_FIELD, a, axis=0))
    )(j(P))
    got = ops.to_affine(ops.FP_FIELD, msm.halving_sum(ops.FP_FIELD, t(P), axis=0))
    assert same(got, want)


def _encodings():
    """Valid points (both signs), infinity, and every kind of bad input."""
    good = [oc.g1_compress(p) for p in g1_points()]
    bad_flags = bytes([0x00]) + good[0][1:]  # compression bit missing
    inf_sign = bytes([0xE0]) + bytes(47)  # infinity with the sign bit
    inf_x = bytes([0xC0]) + bytes(46) + b"\x01"  # infinity with x != 0
    noncanon = bytearray(of.P.to_bytes(48, "big"))
    noncanon[0] |= 0x80
    off = outside = None
    x = 1
    while off is None or outside is None:
        y = oc.fp_sqrt((x * x % of.P * x + 4) % of.P)
        comp = bytearray(x.to_bytes(48, "big"))
        comp[0] |= 0x80
        if y is None:
            off = off or bytes(comp)
        elif not oc.g1_in_subgroup((x, y, 1)):
            outside = outside or bytes(comp)
        x += 1
    return good + [bad_flags, inf_sign, inf_x, bytes(noncanon), off, outside]


def test_g1_decompress_matches_jax():
    comp = np.frombuffer(b"".join(_encodings()), dtype=np.uint8).reshape(-1, 48)
    want = jax.jit(jdec.g1_decompress)(jnp.asarray(comp))
    got = decompress.g1_decompress(torch.as_tensor(comp.copy()))
    assert same(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.tolist() == np.asarray(w).tolist()
    ok = (got[1] & got[2] & got[3]).tolist()
    assert ok == [True] * 5 + [False] * 6
