"""kateth_tpu_torch Fp2/Fp6/Fp12 tower vs kateth_tpu.fields.fp2/fp6/fp12.

Seeded random tower elements go through the jitted JAX function on CPU and
the port's function on CPU tensors; exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kateth_tpu.fields import fp2 as jfp2
from kateth_tpu.fields import fp6 as jfp6
from kateth_tpu.fields import fp12 as jfp12
from kateth_tpu_torch.fields import fp2, fp6, fp12
from kateth_tpu_torch.fields.specs import FP


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rand_tower(seed: int, shape) -> np.ndarray:
    """Canonical random Fp coordinates, (*shape, 24) digits."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 1 << 16, (*shape, 24), dtype=np.int64)
    d[..., -1] = rng.integers(0, int(FP.mod_digits[-1]), shape)
    return d


def check(jax_fn, torch_fn, *arrays):
    want = jax.jit(jax_fn)(*(jnp.asarray(a.astype(np.uint32)) for a in arrays))
    got = torch_fn(*(torch.as_tensor(a) for a in arrays))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


FP2_CASES = {
    "mul": (jfp2.mul, fp2.mul, 2),
    "sqr": (jfp2.sqr, fp2.sqr, 1),
    "inv": (jfp2.inv, fp2.inv, 1),
    "conj": (jfp2.conj, fp2.conj, 1),
    "mul_by_xi": (jfp2.mul_by_xi, fp2.mul_by_xi, 1),
}


@pytest.mark.parametrize("op", sorted(FP2_CASES))
def test_fp2_matches_jax(op):
    jax_fn, torch_fn, arity = FP2_CASES[op]
    x = rand_tower(10, (3, 2))
    x[0] = 0  # zero maps to zero under inv
    args = [x, rand_tower(11, (3, 2))][:arity]
    check(jax_fn, torch_fn, *args)


@pytest.mark.parametrize("op", ["mul", "inv"])
def test_fp6_matches_jax(op):
    x, y = rand_tower(12, (2, 3, 2)), rand_tower(13, (2, 3, 2))
    if op == "mul":
        check(jfp6.mul, fp6.mul, x, y)
    else:
        check(jfp6.inv, fp6.inv, x)


FP12_CASES = {
    "mul": (jfp12.mul, fp12.mul, 2),
    "sqr": (jfp12.sqr, fp12.sqr, 1),
    "inv": (jfp12.inv, fp12.inv, 1),
    "frob": (jfp12.frob, fp12.frob, 1),
    "conj": (jfp12.conj, fp12.conj, 1),
    # the Granger-Scott formula itself, also off the cyclotomic subgroup
    "cyc_sqr": (jfp12.cyc_sqr, fp12.cyc_sqr, 1),
}


@pytest.mark.parametrize("op", sorted(FP12_CASES))
def test_fp12_matches_jax(op):
    jax_fn, torch_fn, arity = FP12_CASES[op]
    args = [rand_tower(14, (2, 2, 3, 2)), rand_tower(15, (2, 2, 3, 2))][:arity]
    check(jax_fn, torch_fn, *args)


def test_frobenius_gammas_match_jax():
    assert np.array_equal(fp12.GAMMA, np.asarray(jfp12._GAMMA).astype(np.int64))


def test_fp12_predicates():
    one = fp12.one((2,))
    x = torch.as_tensor(rand_tower(16, (2, 2, 3, 2)))
    assert fp12.is_one(one).tolist() == [True, True]
    assert fp12.is_one(x).tolist() == [False, False]
    sel = fp12.select(torch.tensor([True, False]), one, x)
    assert torch.equal(sel[0], one[0]) and torch.equal(sel[1], x[1])
    assert torch.equal(fp12.mul(x, fp12.inv(x)), one)
