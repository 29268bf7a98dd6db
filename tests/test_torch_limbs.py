"""kateth_tpu_torch digit-plane field arithmetic vs kateth_tpu.fields.limbs.

The same seeded digit planes go through the JAX function (jitted, on CPU)
and the port's PyTorch function on the CPU, where the kernel wrappers run
their plain versions (K1 mont_mul, K2 pow_chain).  Every value is an
integer field element, so the tolerance is exact equality.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kateth_tpu.fields import limbs as JL
from kateth_tpu.fields.specs import FP as JFP
from kateth_tpu.fields.specs import FR as JFR
from kateth_tpu_torch import cuda_pairing
from kateth_tpu_torch.fields import cuda_mont
from kateth_tpu_torch.fields import limbs as L
from kateth_tpu_torch.fields.specs import FP, FR

SPECS = {"fr": (FR, JFR), "fp": (FP, JFP)}


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rand_elems(seed: int, spec, n: int) -> np.ndarray:
    """n canonical elements as (n, D) digits: N-1, 0, 1, then random."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 1 << 16, (n, spec.n_digits), dtype=np.int64)
    d[:, -1] = rng.integers(0, int(spec.mod_digits[-1]), n)
    d[0] = L.int_to_digits(spec.modulus - 1, spec.n_digits)
    d[1] = 0
    d[2] = L.int_to_digits(1, spec.n_digits)
    return d


def jax_run(fn, *arrays):
    out = jax.jit(fn)(*(jnp.asarray(a.astype(np.uint32)) for a in arrays))
    return jax.tree_util.tree_map(lambda x: np.asarray(x).astype(np.int64), out)


def torch_run(fn, *arrays):
    out = fn(*(torch.as_tensor(a) for a in arrays))
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


@pytest.mark.parametrize("field", ["fr", "fp"])
def test_mont_mul_plain_matches_jax(field):
    spec, jspec = SPECS[field]
    a = rand_elems(1, spec, 24)
    b = rand_elems(2, spec, 24)[::-1].copy()
    want = jax_run(partial(JL.mont_mul, jspec), a, b)
    assert np.array_equal(torch_run(partial(cuda_mont.mont_mul_plain, spec), a, b), want)
    assert np.array_equal(torch_run(partial(L.mont_mul, spec), a, b), want)


@pytest.mark.parametrize("field", ["fr", "fp"])
def test_add_sub_neg_match_jax(field):
    spec, jspec = SPECS[field]
    a = rand_elems(3, spec, 24)
    b = rand_elems(4, spec, 24)[::-1].copy()

    def ops_jax(x, y):
        return JL.add(jspec, x, y), JL.sub(jspec, x, y), JL.neg(jspec, x)

    def ops_torch(x, y):
        return L.add(spec, x, y), L.sub(spec, x, y), L.neg(spec, x)

    for got, want in zip(torch_run(ops_torch, a, b), jax_run(ops_jax, a, b)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("field", ["fr", "fp"])
def test_mont_codecs_match_jax(field):
    spec, jspec = SPECS[field]
    a = rand_elems(5, spec, 16)

    def jax_fn(x):
        return JL.to_mont(jspec, x), JL.from_mont(jspec, x)

    def torch_fn(x):
        return L.to_mont(spec, x), L.from_mont(spec, x)

    for got, want in zip(torch_run(torch_fn, a), jax_run(jax_fn, a)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize(
    "field,exp",
    [
        ("fp", (JFP.modulus + 1) // 4),  # the G1 square root
        ("fp", JFP.modulus - 2),  # Fermat inverse
        ("fr", JFR.modulus - 2),
    ],
    ids=["fp_sqrt", "fp_inverse", "fr_inverse"],
)
def test_pow_const_plain_matches_jax(field, exp):
    spec, jspec = SPECS[field]
    a = rand_elems(6, spec, 4)
    want = jax_run(lambda x: JL.pow_const(jspec, x, exp), a)
    assert np.array_equal(torch_run(lambda x: cuda_mont.pow_const_plain(spec, x, exp), a), want)
    assert np.array_equal(torch_run(lambda x: L.pow_const(spec, x, exp), a), want)


def test_mul_small_matches_jax():
    a = rand_elems(7, FP, 6).reshape(3, 2, 24)
    ks = np.array([12, 36, 8]).reshape(3, 1)
    want = jax_run(lambda x: JL.mul_small(JFP, x, ks), a)
    assert np.array_equal(torch_run(lambda x: L.mul_small(FP, x, ks), a), want)


@pytest.mark.parametrize("field", ["fr", "fp"])
def test_bytes_and_canonicality_match_jax(field):
    spec, jspec = SPECS[field]
    rng = np.random.default_rng(8)
    raw = rng.integers(0, 256, (6, 2 * spec.n_digits), dtype=np.int64)
    raw[0] = 0xFF  # far above N
    raw[1, :] = list(spec.modulus.to_bytes(2 * spec.n_digits, "big"))  # exactly N
    raw[2, :] = list((spec.modulus - 1).to_bytes(2 * spec.n_digits, "big"))

    def jax_fn(b):
        d = JL.be_bytes_to_digits(jspec, b.astype(jnp.uint8))
        return d, JL.lt_modulus(jspec, d)

    def torch_fn(b):
        d = L.be_bytes_to_digits(spec, b.to(torch.uint8))
        return d, L.lt_modulus(spec, d)

    got, want = torch_run(torch_fn, raw), jax_run(jax_fn, raw)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1].astype(bool))
    assert list(got[1][:3]) == [False, False, True]


def test_sum_mod_matches_jax():
    a = rand_elems(9, FR, 8).reshape(2, 4, 16)
    want = jax_run(lambda x: JL.sum_mod(JFR, x, axis=-2), a)
    assert np.array_equal(torch_run(lambda x: L.sum_mod(FR, x, axis=-2), a), want)


def _meta(*shape):
    return torch.empty(shape, dtype=torch.int64, device="meta")


@pytest.mark.parametrize(
    "call,match",
    [
        (lambda: cuda_mont.mont_mul(FR, _meta(2, 16), _meta(2, 16)), "CUDA"),
        (lambda: cuda_mont.pow_const(FR, _meta(2, 16), 5), "CUDA"),
        (lambda: cuda_mont.g1_scalar_mul((_meta(2, 24),) * 3, _meta(2, 16)), "CUDA"),
        (lambda: cuda_pairing.miller_loop_affine(
            _meta(2, 24), _meta(2, 24), _meta(2, 2, 24), _meta(2, 2, 24)), "CUDA"),
        (lambda: cuda_pairing.hard_part(_meta(1, 2, 3, 2, 24)), "CUDA"),
        (lambda: cuda_pairing.g2_scalar_mul((_meta(2, 2, 24),) * 3, _meta(2, 16)), "CUDA"),
        (lambda: cuda_mont.mont_mul(FP, _meta(1, 24), _meta(3, 24)), "CUDA"),
        (lambda: cuda_mont.mont_mul(FR, _meta(2, 24), _meta(2, 24)), "digit planes"),
    ],
    ids=["mont_mul", "pow_chain", "g1_ladder", "miller", "hard_part", "g2_ladder",
         "mont_mul_broadcast", "wrong_width"],
)
def test_wrappers_take_plain_path_only_on_cpu(call, match):
    """A tensor that is not on the CPU goes to the kernel path, which
    checks its operands and rejects a non-CUDA device instead of falling
    back to the plain version."""
    with pytest.raises(ValueError, match=match):
        call()
