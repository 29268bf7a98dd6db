"""K2's sliding-window chain (fields/cuda_mont.py pow_chain), on the CPU.

The kernel runs the chain that pow_chain builds in Python, so the chain is
held here: run with the plain Montgomery product, it gives
pow_const_plain's digits bit for bit over Fp and Fr, for the exponents of
the port's callers and the edges of the range, on inputs that include 0,
1 and N - 1; and for every exponent below 2^512 it fits the launcher's
table of steps.  No JAX."""

import ctypes

import numpy as np
import pytest
import torch

from kateth_tpu_torch.fields import cuda_mont as cm
from kateth_tpu_torch.fields import limbs as L
from kateth_tpu_torch.fields.specs import FP, FR


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _elems(spec, lanes, seed):
    """Random canonical digits; lanes 0-3 are N - 1, 0, 1 and one (R mod N)."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 1 << 16, (lanes, spec.n_digits), dtype=np.int64)
    d[:, -1] = rng.integers(0, int(spec.mod_digits[-1]), lanes)
    d[0] = L.int_to_digits(spec.modulus - 1, spec.n_digits)
    d[1] = 0
    d[2] = L.int_to_digits(1, spec.n_digits)
    d[3] = np.asarray(spec.one_mont)
    return torch.as_tensor(d)


def _run_chain(spec, a, chain):
    """The chain as the kernel runs it, with the plain Montgomery product."""
    mul = lambda x, y: cm.mont_mul_plain(spec, x, y)  # noqa: E731
    table = {1: a}
    if chain.table_max > 1:
        a2 = mul(a, a)
        for d in range(3, chain.table_max + 1, 2):
            table[d] = mul(table[d - 2], a2)
    acc = table[chain.first]
    for s, d in chain.steps:
        for _ in range(s):
            acc = mul(acc, acc)
        if d:
            acc = mul(acc, table[d])
    return acc


_RNG = np.random.default_rng(0x706F77)
_E500 = int.from_bytes(_RNG.bytes(63), "big") >> 4 | 1 << 499  # a random 500-bit e
_CASES = [
    ("fp", "sqrt", (FP.modulus + 1) // 4),
    ("fp", "p-2", FP.modulus - 2),
    ("fr", "r-2", FR.modulus - 2),
    *((f, name, e) for f in ("fp", "fr") for name, e in (
        ("1", 1), ("2", 2), ("3", 3), ("2^100", 1 << 100), ("2^511+1", (1 << 511) + 1),
        ("random500", _E500))),
]


@pytest.mark.parametrize("field,name,e", _CASES, ids=[f"{f}-{n}" for f, n, _ in _CASES])
def test_chain_matches_plain_pow(field, name, e):
    spec = FP if field == "fp" else FR
    a = _elems(spec, 6, e % 1000)
    assert torch.equal(_run_chain(spec, a, cm.pow_chain(e)), cm.pow_const_plain(spec, a, e))


def test_chain_products():
    """The window chain's products against the bit-by-bit chain's: (p+1)/4
    457 against 606, p - 2 460 against 608, r - 2 312 against 417."""
    for e, want in (((FP.modulus + 1) // 4, 457), (FP.modulus - 2, 460), (FR.modulus - 2, 312)):
        assert cm.pow_chain(e).n_products == want
        assert cm.pow_chain(e).window == 5


@pytest.mark.parametrize("seed", range(4))
def test_chain_fits_the_launcher(seed):
    """Every e in [1, 2^512) fits: at most POW_MAX_STEPS steps, windows of
    at most POW_MAX_WINDOW bits, step words of 16 bits; the chain's value
    is e.  Exponents of every length, dense and sparse, and the largest."""
    rng = np.random.default_rng(seed)
    es = [(1 << 512) - 1, 1 << 511, int("10" * 256, 2), int("110" * 170, 2)]
    for bits in map(int, rng.integers(1, 513, 60)):
        top = 1 << (bits - 1)
        e = int.from_bytes(rng.bytes(64), "big") % top | top
        sparse = e & int.from_bytes(rng.bytes(64), "big") & int.from_bytes(rng.bytes(64), "big")
        es += [e, sparse | top]
    for e in es:
        c = cm.pow_chain(e)
        assert len(c.steps) <= cm.POW_MAX_STEPS and c.window <= cm.POW_MAX_WINDOW
        assert all(0 <= w < 1 << 16 for w in c.words())
        value = c.first
        for s, d in c.steps:
            assert 0 <= s < 1 << 10 and (d == 0 or d % 2 == 1) and d < 1 << c.window
            value = (value << s) + d
        assert value == e
        arg = cm._chain_arg(e)
        assert (arg.n_steps, arg.first, arg.table_max) == (len(c.steps), c.first, c.table_max)
        assert list(arg.step)[: arg.n_steps] == c.words()


def test_chain_arg_layout():
    """The ctypes struct has the layout of csrc/pow_team.cuh PowChainArg:
    three ints, then the uint16 steps."""
    assert ctypes.sizeof(cm._PowChainArg) == 12 + 2 * cm.POW_MAX_STEPS
    assert cm._PowChainArg.step.offset == 12


def test_pow_const_range():
    a = _elems(FP, 4, 0)
    for e in (0, 1 << 512):
        with pytest.raises(ValueError):
            cm.pow_const(FP, a, e)
