"""Big-integer modular arithmetic on 16-bit digit planes, in PyTorch.

A field element is a little-endian vector of ``D`` radix-2^16 digits in an
``int64`` tensor of shape ``(..., D)``: Fr has D=16, Fp has D=24.  Elements
live in Montgomery form with R = 2^(16 D) (2^256 for Fr, 2^384 for Fp),
which is also the R of 8 and 12 32-bit limbs, so the CUDA kernels hold
bit-identical Montgomery values after packing digit pairs into limbs.

Every function returns canonical digits (each < 2^16, value < N), so any
grouping of the exact modular operations gives the same bits.  Carries are
resolved with no data-dependent control flow, as the JAX package's
soft_carry and carry_pass do: each caller states a static bound on its
columns, which fixes a number of non-propagating rounds, and one
carry-lookahead step over the digits resolves the 0/1 carries left.  No
function reads a tensor back to the host, so a device runs the arithmetic
without waiting for the host and a CUDA graph can capture it.  The
subtraction keeps the complement trick (a + (2^16-1-b) + 1 per digit), so
no intermediate is ever negative.

Every function is batched over leading dimensions and runs on the device
of its inputs.  `mont_mul` and `pow_const` go through the kernel wrappers
of `cuda_mont`, which launch the CUDA kernels on a CUDA tensor.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, Hashable

import numpy as np
import torch
import torch.nn.functional as F

DIGIT_BITS = 16
DIGIT_MASK = (1 << DIGIT_BITS) - 1


def int_to_digits(v: int, n_digits: int) -> np.ndarray:
    """Python int -> little-endian radix-2^16 digit vector (host side)."""
    if v < 0 or v >> (DIGIT_BITS * n_digits):
        raise ValueError("value does not fit")
    return np.array(
        [(v >> (DIGIT_BITS * i)) & DIGIT_MASK for i in range(n_digits)], dtype=np.int64
    )


def digits_to_int(d) -> int:
    """Digit vector (1-D) -> Python int (host side)."""
    d = np.asarray(d, dtype=np.int64)
    return sum(int(x) << (DIGIT_BITS * i) for i, x in enumerate(d))


def _toeplitz(c: int, n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float64 matrix T with (x @ T)[k] = sum_i x_i c_(k-i):
    the digit convolution of x with the constant c, truncated to n_out."""
    cd = int_to_digits(c % (1 << (DIGIT_BITS * n_out)), n_out)
    t = np.zeros((n_in, n_out), dtype=np.float64)
    for i in range(n_in):
        t[i, i:] = cd[: n_out - i]
    return t


class DeviceConstants:
    """Host arrays made into tensors once per device and kept, so that the
    arithmetic on a device uploads nothing (callers never write to them).
    `make(key)` builds the numpy array of a hashable key."""

    def __init__(self, make: Callable[[Hashable], np.ndarray]):
        self._make = make
        self._tensors: dict = {}

    def get(self, key: Hashable, device) -> torch.Tensor:
        k = (key, str(device))
        t = self._tensors.get(k)
        if t is None:
            t = torch.as_tensor(np.array(self._make(key))).to(device)  # a copy: its own memory
            self._tensors[k] = t
        return t


#: 2^0, ..., 2^(n-1) as int64, keyed by n
_POW2 = DeviceConstants(lambda n: np.left_shift(1, np.arange(n, dtype=np.int64)))


@dataclass(frozen=True, eq=False)
class FieldSpec:
    """Static description of a prime field in digit-plane representation."""

    name: str
    modulus: int
    n_digits: int
    mod_digits: np.ndarray = field(init=False, repr=False)
    one_mont: np.ndarray = field(init=False, repr=False)
    r2_digits: np.ndarray = field(init=False, repr=False)
    nprime_digits: np.ndarray = field(init=False, repr=False)
    _tensors: DeviceConstants = field(init=False, repr=False)

    def __post_init__(self):
        N, D = self.modulus, self.n_digits
        R = 1 << (DIGIT_BITS * D)
        if N % 2 == 0 or N >= R:
            raise ValueError("modulus must be odd and below R")
        object.__setattr__(self, "mod_digits", int_to_digits(N, D))
        object.__setattr__(self, "one_mont", int_to_digits(R % N, D))
        object.__setattr__(self, "r2_digits", int_to_digits(R * R % N, D))
        # N' = -N^-1 mod R for the non-interleaved Montgomery reduction
        object.__setattr__(self, "nprime_digits", int_to_digits((-pow(N, -1, R)) % R, D))
        object.__setattr__(self, "_tensors", DeviceConstants(self._constant))

    def from_int(self, v: int, mont: bool = True) -> np.ndarray:
        v %= self.modulus
        if mont:
            v = (v << (DIGIT_BITS * self.n_digits)) % self.modulus
        return int_to_digits(v, self.n_digits)

    def to_int(self, d, mont: bool = True) -> int:
        v = digits_to_int(d)
        if mont:
            v = v * pow(1 << (DIGIT_BITS * self.n_digits), -1, self.modulus)
        return v % self.modulus

    def tensor(self, name: str, device) -> torch.Tensor:
        """The named constant as a tensor on `device`, made once per device
        (constants only: callers never write to it)."""
        return self._tensors.get(name, device)

    def _constant(self, name: str) -> np.ndarray:
        D, N = self.n_digits, self.modulus
        if name == "nprime_toeplitz":  # low half of x * N'
            return _toeplitz(int(digits_to_int(self.nprime_digits)), D, D)
        if name == "mod_toeplitz":  # full x * N
            return _toeplitz(N, D, 2 * D)
        one = np.eye(1, D, dtype=np.int64)[0]
        if name == "neg_base":  # neg's N + R - a: N_i + 2^16 - 1 - a_i, plus 1 at digit 0
            if self.mod_digits[0] >= DIGIT_MASK:  # digit 0 would exceed 2 (2^16 - 1)
                raise ValueError("neg needs N's digit 0 below 2^16 - 1")
            return self.mod_digits + DIGIT_MASK + one
        if name == "neg_mod_shifts":  # 2^(16 (D+1)) - (N << j) in D+1 digits, j < 7
            return np.stack([int_to_digits((1 << (DIGIT_BITS * (D + 1))) - (N << j), D + 1)
                             for j in range(7)])
        if name == "r_minus_mod":  # R - N: x + (R - N) carries out iff x >= N
            return int_to_digits((1 << (DIGIT_BITS * D)) - N, D)
        if name == "add_rows":  # add's two rows: a + b, a + b + (R - N)
            return np.stack([np.zeros(D, dtype=np.int64), self._constant("r_minus_mod")])
        if name == "sub_rows":  # sub's: a - b + R (2^16 - 1 a digit, plus 1), and + N
            return DIGIT_MASK + one + np.stack([np.zeros(D, dtype=np.int64), self.mod_digits])
        if name == "conv_scatter":  # (D^2, 2D): digit product (i, j) -> column i + j
            arr = np.zeros((D * D, 2 * D), dtype=np.float64)
            for i in range(D):
                arr[i * D : (i + 1) * D, i : i + D] = np.eye(D)
            return arr
        return getattr(self, name)


# ---------------------------------------------------------------------------
# carry and borrow machinery
# ---------------------------------------------------------------------------

#: the largest column the carry-lookahead step takes: a digit below
#: 2^17 - 1 plus an incoming carry of 1 passes on a carry of at most 1
LOOKAHEAD_MAX = (1 << (DIGIT_BITS + 1)) - 2


def carry_rounds(col_max: int) -> int:
    """The soft rounds that take columns of at most col_max to at most
    LOOKAHEAD_MAX: a round leaves at most 2^16 - 1 + (col_max >> 16) in a
    column."""
    rounds = 0
    while col_max > LOOKAHEAD_MAX:
        col_max = DIGIT_MASK + (col_max >> DIGIT_BITS)
        rounds += 1
    return rounds


#: the lookahead's thresholds: a column of 2^16 - 1 or more generates or
#: passes on a carry (x), one of 2^16 or more generates one (y)
_XY_MIN = DeviceConstants(lambda _: np.array([[DIGIT_MASK], [1 << DIGIT_BITS]], dtype=np.int64))
#: the lookahead's weights for W columns, (2, 2, W): column i adds
#: (x_i + y_i) 2^i to P = X + Y and (x_i - y_i) 2^i to Q = X - Y
_PQ_WEIGHTS = DeviceConstants(
    lambda W: np.array([[1, 1], [1, -1]], dtype=np.int64)[:, :, None] << np.arange(W))


def _soft_rounds(t: torch.Tensor, col_max: int):
    """carry_rounds(col_max) rounds over non-negative columns, each at most
    col_max: each moves every column's overflow one column up.  Returns
    (columns, each at most LOOKAHEAD_MAX; what left the top column in each
    round, a list of (...,) views)."""
    tops = []
    for _ in range(carry_rounds(col_max)):
        c = t >> DIGIT_BITS
        t = t & DIGIT_MASK
        t[..., 1:] += c[..., :-1]
        tops.append(c[..., -1])
    return t, tops


def _lookahead(t: torch.Tensor, carry_in=0):
    """Columns each at most LOOKAHEAD_MAX, plus a carry_in (0 or 1, an int
    or a (...,) tensor) into column 0 -> (canonical digits, carry out of the
    top: bool (...,)).

    Every carry is 0 or 1: a column of 2^16 or more generates one, a column
    of 2^16 - 1 passes one on.  With x_i = (column i generates or passes
    on) and y_i = (column i generates) packed into X and Y (W + 1 <= 49
    bits), the binary sum X + Y + carry_in holds in (X + Y + carry_in) ^ X
    ^ Y the carry into every digit at once, and in bit W the carry out;
    X ^ Y = X - Y, as y_i implies x_i."""
    W = t.shape[-1]
    xy = t[..., None, :] >= _XY_MIN.get(None, t.device)
    pq = (xy[..., None, :, :] * _PQ_WEIGHTS.get(W, t.device)).sum((-2, -1))
    c = pq[..., 0] if isinstance(carry_in, int) and not carry_in else pq[..., 0] + carry_in
    carries = ((c ^ pq[..., 1])[..., None] & _POW2.get(W + 1, t.device)) != 0
    digits = t + carries[..., :W]
    digits &= DIGIT_MASK
    return digits, carries[..., W]


def _carry(t: torch.Tensor, col_max: int, carry_in=0):
    """Carry-propagate non-negative columns, each at most col_max, plus a
    carry_in into column 0 -> (canonical digits, carry out of the top: a
    bool, whether the value reaches 2^(16 W)).  A column above col_max is
    outside the contract: its digits come out wrong."""
    t, tops = _soft_rounds(t, col_max)
    digits, out = _lookahead(t, carry_in)
    for top in tops:
        out = torch.logical_or(out, top)
    return digits, out


def _normalize(t: torch.Tensor, col_max: int, carry_in=0) -> torch.Tensor:
    """_carry's digits, the value mod 2^(16 W): what leaves the top column
    is dropped, at no cost."""
    return _lookahead(_soft_rounds(t, col_max)[0], carry_in)[0]


def _geq(a: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """a >= n for canonical digit vectors (n broadcastable); bool (...,).

    The most significant differing digit decides: the weighted sum of the
    per-digit signs with weights 2^i has that digit's sign."""
    return (torch.sign(a - n) * _POW2.get(a.shape[-1], a.device)).sum(-1) >= 0


def cond_sub_mod(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """If a >= N subtract N (a < 2N, canonical digits)."""
    d, carry = _carry(a + spec.tensor("r_minus_mod", a.device), 2 * DIGIT_MASK)
    return torch.where(carry[..., None], d, a)


def _rows(spec: FieldSpec, name: str, x: torch.Tensor) -> torch.Tensor:
    """The (2, D) constant `name`, shaped to add to x[None] as two rows."""
    return spec.tensor(name, x.device).view(2, *(1,) * (x.dim() - 1), spec.n_digits)


# ---------------------------------------------------------------------------
# field ops (Montgomery domain unless stated otherwise)
# ---------------------------------------------------------------------------

def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod N.  a + b and a + b + (R - N) are carried together; the
    second carries out of the top digit iff a + b >= N."""
    s = a + b
    both, carry = _carry(s[None] + _rows(spec, "add_rows", s), 3 * DIGIT_MASK)
    return torch.where(carry[1][..., None], both[1], both[0])


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod N.  a - b + R (the complement trick: a_i + 2^16 - 1 - b_i
    by digit, plus 1 at digit 0) and a - b + N + R are carried together;
    the first carries out iff a >= b."""
    s = a - b
    both, carry = _carry(s[None] + _rows(spec, "sub_rows", s), 3 * DIGIT_MASK + 1)
    return torch.where(carry[0][..., None], both[0], both[1])


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """(-a) mod N, with -0 = 0: N + R - a, mod R."""
    diff = _normalize(spec.tensor("neg_base", a.device) - a, 2 * DIGIT_MASK)
    return torch.where(is_zero(a)[..., None], a, diff)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(-1)


def lt_modulus(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Canonicality check a < N."""
    return ~_geq(a, spec.tensor("mod_digits", a.device))


def _conv_digits(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Digit-plane product columns sum_{i+j=c} a_i b_j, (..., 2D): the
    (..., D, D) digit products summed into their columns by one float64
    matrix product.  Products of digits < 2^16 stay below 2^32 and a column
    sums at most D of them, below 2^37, so float64 is exact."""
    prod = a.to(torch.float64).unsqueeze(-1) * b.to(torch.float64).unsqueeze(-2)
    return torch.matmul(prod.flatten(-2), spec.tensor("conv_scatter", a.device)).to(torch.int64)


def _mul_const(x: torch.Tensor, toeplitz: torch.Tensor) -> torch.Tensor:
    """Digit convolution with a constant as one float64 matrix product:
    digits < 2^16 times constant digits < 2^16, summed over at most 24
    terms, stay below 2^37 and so are exact in float64."""
    return torch.matmul(x.to(torch.float64), toeplitz).to(torch.int64)


def conv_max(spec: FieldSpec) -> int:
    """The largest column of a digit convolution of two D-digit operands
    (_conv_digits, _mul_const): D products of 16-bit digits, below 2^37."""
    return spec.n_digits * DIGIT_MASK**2


def mont_reduce(spec: FieldSpec, t: torch.Tensor, col_max: int | None = None) -> torch.Tensor:
    """Montgomery reduction of (..., 2D) columns, each at most col_max
    (default conv_max(spec)), with value < N R: M = (t mod R) N' mod R,
    then (t + M N) / R, then one conditional subtraction.

    The low halves of t and M N sum to 0 or R (their sum is a multiple of
    R below 2R), so the high half is t_hi + (MN)_hi plus that one carry,
    found without rippling a carry through D zero digits."""
    D = spec.n_digits
    cmax = conv_max(spec)
    if col_max is None:
        col_max = cmax
    if col_max > DIGIT_MASK:
        t = _normalize(t, col_max)
    m = _normalize(_mul_const(t[..., :D], spec.tensor("nprime_toeplitz", t.device)), cmax)
    u = _normalize(_mul_const(m, spec.tensor("mod_toeplitz", t.device)), cmax)
    low_carry = (t[..., :D] | u[..., :D]).any(-1)
    # (t + M N) / R < 2N < R: no carry out
    res = _normalize(t[..., D:] + u[..., D:], 2 * DIGIT_MASK, carry_in=low_carry)
    return cond_sub_mod(spec, res)


@functools.cache
def _wrappers():
    """The kernel wrappers (cuda_mont), bound at the first call and kept:
    cuda_mont imports this module, so it cannot be imported at the top."""
    from . import cuda_mont

    return cuda_mont


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a b R^-1 mod N (kernel K1 on a CUDA tensor)."""
    return _wrappers().mont_mul(spec, a, b)


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, a)


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Standard -> Montgomery form (multiply by R^2)."""
    return mont_mul(spec, a, spec.tensor("r2_digits", a.device).expand_as(a))


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery -> standard form (reduction with a zero high half)."""
    return mont_reduce(spec, F.pad(a, (0, spec.n_digits)), col_max=DIGIT_MASK)


#: mul_small's arrays of small constants, keyed by (shape, bytes)
_SMALL_KS = DeviceConstants(lambda key: np.frombuffer(key[1], dtype=np.int64).reshape(key[0]))


def mul_small(spec: FieldSpec, a: torch.Tensor, k) -> torch.Tensor:
    """a * k for small constant(s) 0 < k < 128; stays in Montgomery form.

    k is an int or an integer array broadcastable against a's batch dims
    (on the device once per array's value and shape).  The product is
    formed in D+1 digits (k N can exceed R), then reduced by conditionally
    subtracting N 2^j for j from high to low."""
    if isinstance(k, int):
        kmax = k
        kt = k
    else:
        karr = np.asarray(k, dtype=np.int64)
        kmax = int(karr.max())
        kt = _SMALL_KS.get((karr.shape, karr.tobytes()), a.device)[..., None]
    if not 0 < kmax < 128:
        raise ValueError("mul_small takes 0 < k < 128")
    t = _normalize(F.pad(a, (0, 1)) * kt, DIGIT_MASK * kmax)
    negs = spec.tensor("neg_mod_shifts", a.device)
    for j in range(kmax.bit_length() - 1, -1, -1):
        # t + 2^(16 (D+1)) - (N << j) carries out iff t >= N << j
        diff, ge = _carry(t + negs[j], 2 * DIGIT_MASK)
        t = torch.where(ge[..., None], diff, t)
    return t[..., : spec.n_digits]


def pow_const(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a static exponent e >= 0 (Montgomery in and out); every
    e >= 1 is one pow-chain kernel K2 launch on a CUDA tensor."""
    if e < 0:
        raise ValueError("negative exponent")
    if e == 0:
        return spec.tensor("one_mont", a.device).expand_as(a).clone()
    return _wrappers().pow_const(spec, a, e)


def inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^-1 via Fermat (a^(N-2)); zero maps to zero."""
    return pow_const(spec, a, spec.modulus - 2)


def scan_mul(spec: FieldSpec, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix (or suffix) products along axis -2, Hillis-Steele:
    log2(n) rounds of one batched Montgomery multiply each."""
    n = x.shape[-2]
    one = spec.tensor("one_mont", x.device)
    shift = 1
    while shift < n:
        ones = one.expand(*x.shape[:-2], shift, spec.n_digits)
        if reverse:
            shifted = torch.cat([x[..., shift:, :], ones], dim=-2)
        else:
            shifted = torch.cat([ones, x[..., : n - shift, :]], dim=-2)
        x = mont_mul(spec, x, shifted)
        shift *= 2
    return x


def batch_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery's batched inversion along axis -2: one Fermat chain per
    row plus prefix and suffix products.  Zeros pass through as zeros
    (they count as one in the running products)."""
    one = spec.tensor("one_mont", a.device)
    zero_mask = is_zero(a)[..., None]
    safe = torch.where(zero_mask, one, a)
    prefix = scan_mul(spec, safe)
    suffix = scan_mul(spec, safe, reverse=True)
    total_inv = inv(spec, prefix[..., -1:, :])
    ones = one.expand(*a.shape[:-2], 1, spec.n_digits)
    prefix_shift = torch.cat([ones, prefix[..., :-1, :]], dim=-2)
    suffix_shift = torch.cat([suffix[..., 1:, :], ones], dim=-2)
    out = mont_mul(spec, mont_mul(spec, prefix_shift, suffix_shift), total_inv)
    return torch.where(zero_mask, 0, out)


def sum_mod(spec: FieldSpec, x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Modular sum along `axis` by pairwise folding (power-of-two length)."""
    n = x.shape[axis]
    if n <= 0 or n & (n - 1):
        raise ValueError("sum_mod needs a power-of-two length")
    while n > 1:
        x = add(spec, x.narrow(axis, 0, n // 2), x.narrow(axis, n // 2, n // 2))
        n //= 2
    return x.squeeze(axis)


# ---------------------------------------------------------------------------
# byte codecs
# ---------------------------------------------------------------------------

def be_bytes_to_digits(spec: FieldSpec, b: torch.Tensor) -> torch.Tensor:
    """(..., 2D) big-endian uint8 bytes -> (..., D) digit planes (plain
    form, not reduced or validated; see lt_modulus)."""
    D = spec.n_digits
    pairs = b.to(torch.int64).reshape(*b.shape[:-1], D, 2)
    words = (pairs[..., 0] << 8) | pairs[..., 1]
    return words.flip(-1)


def digits_to_be_bytes(spec: FieldSpec, d: torch.Tensor) -> torch.Tensor:
    """(..., D) digit planes (plain form) -> (..., 2D) big-endian uint8."""
    words = d.flip(-1)
    pairs = torch.stack([(words >> 8) & 0xFF, words & 0xFF], dim=-1)
    return pairs.reshape(*d.shape[:-1], 2 * spec.n_digits).to(torch.uint8)
