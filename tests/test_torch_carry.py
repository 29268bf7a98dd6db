"""The port's data-independent carry (fields/limbs.py `_carry`) against
Python integers and against the JAX package's limbs functions.

Each caller of `_carry` states a static bound on its columns; the bound
fixes the number of soft rounds, and one carry-lookahead step resolves the
0/1 carries left.  The field operations built on it are held bit for bit
against Python integers and against `kateth_tpu.fields.limbs`, run
eagerly on the CPU (never under jax.jit): add, sub, neg, cond_sub_mod,
from_mont and mul_small over Fr and Fp.  `_carry` itself is held against
Python integers on the worst cases: all digits 0xFFFF plus a carry in,
every caller's column at its stated bound, and a carry that ripples
through all D digits, with the carry out; and a column above a bound is
shown to be outside the contract.  Every value is an integer, so the
tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kateth_tpu.fields import limbs as JL
from kateth_tpu.fields.specs import FP as JFP
from kateth_tpu.fields.specs import FR as JFR
from kateth_tpu_torch.fields import limbs as L
from kateth_tpu_torch.fields.specs import FP, FR

SPECS = {"fr": (FR, JFR), "fp": (FP, JFP)}
MASK = L.DIGIT_MASK

#: each caller's column bound, its soft rounds, and the columns it carries
#: (D for the operands' width, 2D for a convolution's, D + 1 for mul_small)
CALLERS = {
    "add": (3 * MASK, 1),  # a + b + (R - N)
    "sub": (3 * MASK + 1, 1),  # a + (2^16 - 1 - b) + N, plus 1 at digit 0
    "neg": (2 * MASK, 0),  # N + (2^16 - 1 - a), plus 1 at digit 0 (N_0 < 2^16 - 1)
    "mul_small's subtraction": (2 * MASK, 0),  # t + 2^(16 (D+1)) - (N << j)
    "cond_sub_mod": (2 * MASK, 0),  # a + (R - N)
    "mul_small": (127 * MASK, 1),  # a k, k < 128
    "mont_reduce high half": (2 * MASK, 0),  # t_hi + (M N)_hi, carry in
}


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rand_elems(rng, spec, n: int) -> np.ndarray:
    """n canonical elements as (n, D) digits: N - 1, 0, 1, then random."""
    d = rng.integers(0, 1 << 16, (n, spec.n_digits), dtype=np.int64)
    d[:, -1] = rng.integers(0, int(spec.mod_digits[-1]), n)
    d[0] = L.int_to_digits(spec.modulus - 1, spec.n_digits)
    d[1] = 0
    d[2] = L.int_to_digits(1, spec.n_digits)
    return d


def ints(d) -> list[int]:
    return [L.digits_to_int(row) for row in np.asarray(d).reshape(-1, np.asarray(d).shape[-1])]


def jax_eager(fn, *arrays) -> np.ndarray:
    """fn on uint32 jnp arrays, op by op (no jax.jit), back as int64."""
    return np.asarray(fn(*(jnp.asarray(a.astype(np.uint32)) for a in arrays))).astype(np.int64)


def column_value(cols: np.ndarray, carry_in) -> list[int]:
    """The integer sum of each row of columns, plus its carry in."""
    cin = np.broadcast_to(np.asarray(carry_in, dtype=np.int64), cols.shape[:-1]).reshape(-1)
    return [sum(int(c) << (16 * i) for i, c in enumerate(row)) + int(ci)
            for row, ci in zip(cols.reshape(-1, cols.shape[-1]), cin)]


def check_carry(cols: np.ndarray, col_max: int, carry_in=0):
    """_carry(cols, col_max, carry_in) against Python integers: digits and
    carry out of each row (whether its value reaches 2^(16 D))."""
    D = cols.shape[-1]
    cin = carry_in if isinstance(carry_in, int) else torch.as_tensor(carry_in)
    digits, out = L._carry(torch.as_tensor(cols), col_max, cin)
    want = column_value(cols, carry_in)
    assert ints(digits.numpy()) == [v % (1 << (16 * D)) for v in want]
    assert out.dtype == torch.bool
    assert out.reshape(-1).tolist() == [v >> (16 * D) != 0 for v in want]
    assert int(digits.max()) <= MASK


@pytest.mark.parametrize("field", ["fr", "fp"])
def test_field_ops_match_ints_and_jax(field):
    spec, jspec = SPECS[field]
    N, D = spec.modulus, spec.n_digits
    R = 1 << (16 * D)
    rng = np.random.default_rng(31)
    a, b = rand_elems(rng, spec, 48), rand_elems(rng, spec, 48)[::-1].copy()
    ai, bi = ints(a), ints(b)
    # a < 2N for cond_sub_mod: N - 1 + N, N, then random in [0, 2N)
    two_n = [2 * N - 1, N, N - 1] + [int(v) % (2 * N) for v in rng.integers(0, 1 << 62, 45)]
    two_n = [v if i < 3 else (v * (1 << (16 * D - 62))) % (2 * N) for i, v in enumerate(two_n)]
    c = np.stack([L.int_to_digits(v, D) for v in two_n])
    ks = rng.integers(1, 128, 48)
    ta, tb, tc = torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)
    cases = [
        ("add", L.add(spec, ta, tb), [(x + y) % N for x, y in zip(ai, bi)],
         jax_eager(lambda x, y: JL.add(jspec, x, y), a, b)),
        ("sub", L.sub(spec, ta, tb), [(x - y) % N for x, y in zip(ai, bi)],
         jax_eager(lambda x, y: JL.sub(jspec, x, y), a, b)),
        ("neg", L.neg(spec, ta), [(-x) % N for x in ai],
         jax_eager(lambda x: JL.neg(jspec, x), a)),
        ("cond_sub_mod", L.cond_sub_mod(spec, tc), [v % N for v in two_n],
         jax_eager(lambda x: JL.cond_sub_mod(jspec, x), c)),
        ("from_mont", L.from_mont(spec, ta), [x * pow(R, -1, N) % N for x in ai],
         jax_eager(lambda x: JL.from_mont(jspec, x), a)),
        ("mul_small 127", L.mul_small(spec, ta, 127), [x * 127 % N for x in ai],
         jax_eager(lambda x: JL.mul_small(jspec, x, 127), a)),
        ("mul_small ks", L.mul_small(spec, ta, ks), [x * int(k) % N for x, k in zip(ai, ks)],
         jax_eager(lambda x: JL.mul_small(jspec, x, ks), a)),
    ]
    for name, got, want_ints, want_jax in cases:
        assert ints(got.numpy()) == want_ints, name
        assert np.array_equal(got.numpy(), want_jax), name


@pytest.mark.parametrize("field", ["fr", "fp"])
def test_mont_reduce_at_its_column_bound(field):
    """2D-column inputs whose low columns are at the convolution's bound,
    as many as keep the value below N R (the reduction's contract), then
    the same columns at the bound and zero in turns, and a high half of
    0xFFFF digits: the reduction against Python integers."""
    spec = SPECS[field][0]
    N, D = spec.modulus, spec.n_digits
    R = 1 << (16 * D)
    cmax = L.conv_max(spec)
    assert cmax < 1 << 37 and L.carry_rounds(cmax) == 2
    k = max(j for j in range(1, 2 * D + 1) if column_value(np.full((1, j), cmax), 0)[0] < N * R)
    assert k > D
    full = [cmax] * k + [0] * (2 * D - k)
    turns = [c if i % 2 == 0 else 0 for i, c in enumerate(full)]
    cols = np.array([full, turns, [0] * D + [MASK] * (D - 1) + [0]], dtype=np.int64)
    vals = column_value(cols, 0)
    assert all(v < N * R for v in vals)
    got = L.mont_reduce(spec, torch.as_tensor(cols))
    assert ints(got.numpy()) == [v * pow(R, -1, N) % N for v in vals]


@pytest.mark.parametrize("D", [16, 24, 25, 48])
def test_carry_worst_cases(D):
    """All digits 0xFFFF plus a carry in (a carry through all D digits and
    out), 2^16 at digit 0 before D - 1 digits of 0xFFFF, and every caller's
    column bound in every column, with and without a carry in."""
    rng = np.random.default_rng(D)
    ripple = np.full((1, D), MASK)
    check_carry(ripple, 2 * MASK, carry_in=1)
    check_carry(ripple, 2 * MASK, carry_in=0)
    gen = ripple.copy()
    gen[0, 0] = 1 << 16
    check_carry(gen, 2 * MASK)
    for name, (bound, rounds) in CALLERS.items():
        assert L.carry_rounds(bound) == rounds, name
        cols = np.stack([np.full(D, bound), rng.integers(0, bound + 1, D),
                         np.where(np.arange(D) % 2 == 0, bound, MASK)])
        check_carry(cols, bound, carry_in=0)
        check_carry(cols, bound, carry_in=1)
        check_carry(cols, bound, carry_in=np.array([1, 0, 1]))
    big = L.conv_max(FP)
    cols = np.stack([np.full(D, big), rng.integers(0, big + 1, D)])
    check_carry(cols, big)


def test_above_a_bound_is_outside_the_contract():
    """A column above what a caller's rounds take leaves a carry of 2, which
    the lookahead step cannot pass on: the digits come out wrong."""
    assert L.LOOKAHEAD_MAX == (1 << 17) - 2 and L.carry_rounds(L.LOOKAHEAD_MAX) == 0
    cols = np.zeros((1, 16), dtype=np.int64)
    cols[0, 0] = L.LOOKAHEAD_MAX + 1  # 2^17 - 1, plus a carry in: 2^17
    digits, _ = L._carry(torch.as_tensor(cols), 2 * MASK, carry_in=1)
    assert ints(digits.numpy()) != column_value(cols, 1)
    # add's one round takes columns up to 3 (2^16 - 1), not 2^33
    cols[0, 0] = 1 << 33
    digits, _ = L._carry(torch.as_tensor(cols), CALLERS["add"][0])
    assert ints(digits.numpy()) != column_value(cols, 0)
    check_carry(cols, 1 << 33)  # with the rounds for its own bound it is exact
