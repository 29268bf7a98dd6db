"""kateth_tpu_torch pairing vs the pure-Python oracle (kateth_tpu.oracle).

The port runs on CPU tensors, so the Miller loop and the hard part take
the plain versions of kernels K4 and K5.  Individual Miller values are only
defined up to factors the final exponentiation kills, so the Miller loop
is checked after final exponentiation against the oracle pairing; the
final exponentiation is bit-exact on its own.  (The JAX pairing's XLA
compile takes minutes on this CPU, so the oracle is the reference here.)
"""

import random

import pytest
import torch

from kateth_tpu.oracle import curve as oc
from kateth_tpu.oracle import field as of
from kateth_tpu.oracle import pairing as op
from kateth_tpu_torch import pairing
from kateth_tpu_torch.curves import g1, g2
from kateth_tpu_torch.fields import fp12

rng = random.Random(0x70616972)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rand_fp12():
    def rand_fp6():
        return tuple((rng.randrange(of.P), rng.randrange(of.P)) for _ in range(3))

    return (rand_fp6(), rand_fp6())


def dev_g1(pts):
    return tuple(torch.as_tensor(a) for a in g1.from_ints(pts))


def dev_g2(pts):
    return tuple(torch.as_tensor(a) for a in g2.from_ints(pts))


def test_final_exponentiation_matches_oracle():
    v = rand_fp12()
    out = pairing.final_exponentiation(torch.as_tensor(fp12.from_ints(v))[None])
    assert fp12.to_ints(out[0].numpy()) == op.final_exponentiation(v)


def test_miller_loop_after_final_exp_matches_oracle_pairing():
    p = oc.g1_mul(oc.G1_GEN, rng.randrange(1, of.R))
    q = oc.g2_mul(oc.G2_GEN, rng.randrange(1, of.R))
    f = pairing.miller_loop(dev_g1([p]), dev_g2([q]))
    got = pairing.final_exponentiation(f)
    assert fp12.to_ints(got[0].numpy()) == op.pairing(p, q)


def test_verify_pairings_true_false_infinity():
    """One batched call over three checks: e(aP, Q) == e(P, aQ) holds,
    e(aP, Q) == e(P, Q) does not, and infinity on both sides holds."""
    a = rng.randrange(2, of.R)
    p1 = oc.g1_mul(oc.G1_GEN, rng.randrange(1, of.R))
    q2 = oc.g2_mul(oc.G2_GEN, rng.randrange(1, of.R))
    ap1, aq2 = oc.g1_mul(p1, a), oc.g2_mul(q2, a)
    inf = oc.g1_infinity()
    lhs = (dev_g1([ap1, ap1, inf]), dev_g2([q2, q2, q2]))
    rhs = (dev_g1([p1, p1, inf]), dev_g2([aq2, q2, oc.G2_GEN]))
    assert pairing.verify_pairings(lhs, rhs).tolist() == [True, False, True]
    assert op.verify_pairings((ap1, q2), (p1, aq2)) and not op.verify_pairings((ap1, q2), (p1, q2))

