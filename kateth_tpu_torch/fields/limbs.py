"""Big-integer modular arithmetic on 16-bit digit planes, in PyTorch.

A field element is a little-endian vector of ``D`` radix-2^16 digits in an
``int64`` tensor of shape ``(..., D)``: Fr has D=16, Fp has D=24.  Elements
live in Montgomery form with R = 2^(16 D) (2^256 for Fr, 2^384 for Fp),
which is also the R of 8 and 12 32-bit limbs, so the CUDA kernels hold
bit-identical Montgomery values after packing digit pairs into limbs.

Every function returns canonical digits (each < 2^16, value < N), so any
grouping of the exact modular operations gives the same bits.  Carries are
resolved by repeated non-propagating rounds until no digit overflows; the
subtraction keeps the complement trick (a + (2^16-1-b) + 1 per digit), so
no intermediate is ever negative.

Every function is batched over leading dimensions and runs on the device
of its inputs.  `mont_mul` and `pow_const` go through the kernel wrappers
of `cuda_mont`, which launch the CUDA kernels on a CUDA tensor.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

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
    _tensors: dict = field(init=False, repr=False, default_factory=dict)

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
        key = (name, str(device))
        t = self._tensors.get(key)
        if t is None:
            D, N = self.n_digits, self.modulus
            if name == "nprime_toeplitz":  # low half of x * N'
                arr = _toeplitz(int(digits_to_int(self.nprime_digits)), D, D)
            elif name == "mod_toeplitz":  # full x * N
                arr = _toeplitz(N, D, 2 * D)
            elif name == "mod_shifts":  # N << j in D+1 digits, j < 7
                arr = np.stack([int_to_digits(N << j, D + 1) for j in range(7)])
            elif name == "r_minus_mod":  # R - N: x + (R - N) carries out iff x >= N
                arr = int_to_digits((1 << (DIGIT_BITS * D)) - N, D)
            elif name == "conv_scatter":  # (D^2, 2D): digit product (i, j) -> column i + j
                arr = np.zeros((D * D, 2 * D), dtype=np.float64)
                for i in range(D):
                    arr[i * D : (i + 1) * D, i : i + D] = np.eye(D)
            else:
                arr = getattr(self, name)
            t = torch.as_tensor(np.ascontiguousarray(arr)).to(device)
            self._tensors[key] = t
        return t


# ---------------------------------------------------------------------------
# carry and borrow machinery
# ---------------------------------------------------------------------------

def _norm(t: torch.Tensor):
    """Carry-propagate non-negative columns into canonical 16-bit digits.

    Each round moves every column's overflow one column up; rounds repeat
    until no column overflows.  Returns (digits, carry out of the top)."""
    carry_out = None
    while True:
        c = t >> DIGIT_BITS
        if not bool(c.any()):
            if carry_out is None:
                carry_out = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
            return t, carry_out
        t = t & DIGIT_MASK
        t[..., 1:] += c[..., :-1]
        carry_out = c[..., -1] if carry_out is None else carry_out + c[..., -1]


def _geq(a: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """a >= n for canonical digit vectors (n broadcastable); bool (...,).

    The most significant differing digit decides: the weighted sum of the
    per-digit signs with weights 2^i has that digit's sign."""
    D = a.shape[-1]
    w = torch.ones((), dtype=torch.int64, device=a.device) << torch.arange(D, device=a.device)
    s = ((a > n).long() - (a < n).long()) * w
    return s.sum(-1) >= 0


def _sub_digits(a: torch.Tensor, b: torch.Tensor):
    """(a - b) mod 2^(16 D) with its borrow, as a + (2^16-1-b) + 1."""
    s = a + (DIGIT_MASK - b)
    s[..., 0] += 1
    diff, carry = _norm(s)
    return diff, 1 - carry


def cond_sub_mod(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """If a >= N subtract N (a < 2N, canonical digits)."""
    d, carry = _norm(a + spec.tensor("r_minus_mod", a.device))
    return torch.where((carry == 1)[..., None], d, a)


# ---------------------------------------------------------------------------
# field ops (Montgomery domain unless stated otherwise)
# ---------------------------------------------------------------------------

def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod N.  a + b and a + b + (R - N) are carried together; the
    second carries out of the top digit iff a + b >= N."""
    s = a + b
    both, carry = _norm(torch.stack([s, s + spec.tensor("r_minus_mod", s.device)]))
    return torch.where((carry[1] == 1)[..., None], both[1], both[0])


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod N.  a - b + R (the complement trick) and a - b + N + R
    are carried together; the first carries out iff a >= b."""
    s = a + (DIGIT_MASK - b)
    s[..., 0] += 1
    both, carry = _norm(torch.stack([s, s + spec.tensor("mod_digits", s.device)]))
    return torch.where((carry[0] == 1)[..., None], both[0], both[1])


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """(-a) mod N, with -0 = 0."""
    diff, _ = _sub_digits(spec.tensor("mod_digits", a.device), a)
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


def mont_reduce(spec: FieldSpec, t: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction of (..., 2D) columns with value < N R:
    M = (t mod R) N' mod R, then (t + M N) / R, then one conditional
    subtraction.

    The low halves of t and M N sum to 0 or R (their sum is a multiple of
    R below 2R), so the high half is t_hi + (MN)_hi plus that one carry,
    found without rippling a carry through D zero digits."""
    D = spec.n_digits
    t, _ = _norm(t)
    m, _ = _norm(_mul_const(t[..., :D], spec.tensor("nprime_toeplitz", t.device)))
    u, _ = _norm(_mul_const(m, spec.tensor("mod_toeplitz", t.device)))
    hi = t[..., D:] + u[..., D:]
    hi[..., 0] += (~(is_zero(t[..., :D]) & is_zero(u[..., :D]))).long()
    res, _ = _norm(hi)  # (t + M N) / R < 2N < R: no carry out
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
    return mont_reduce(spec, F.pad(a, (0, spec.n_digits)))


def mul_small(spec: FieldSpec, a: torch.Tensor, k) -> torch.Tensor:
    """a * k for small constant(s) 0 < k < 128; stays in Montgomery form.

    k is an int or an integer array broadcastable against a's batch dims.
    The product is formed in D+1 digits (k N can exceed R), then reduced by
    conditionally subtracting N 2^j for j from high to low."""
    if isinstance(k, int):
        kmax = k
        kt = k
    else:
        karr = np.asarray(k, dtype=np.int64)
        kmax = int(karr.max())
        kt = torch.as_tensor(karr).to(a.device)[..., None]
    if not 0 < kmax < 128:
        raise ValueError("mul_small takes 0 < k < 128")
    t, _ = _norm(F.pad(a, (0, 1)) * kt)
    shifts = spec.tensor("mod_shifts", a.device)
    for j in range(kmax.bit_length() - 1, -1, -1):
        diff, borrow = _sub_digits(t, shifts[j])
        t = torch.where((borrow == 0)[..., None], diff, t)
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
