"""Wrappers for the field kernels K1-K3, each beside its plain version, and
K2's sliding-window chain.

On a CUDA tensor a wrapper launches its kernel (csrc/kernels.cu) or raises;
on a CPU tensor it runs the plain PyTorch version, which computes the same
canonical digits.  Operands keep the digit-plane layout (..., D); the
kernels read and write it directly, so a wrapper only broadcasts, makes
the operands contiguous and allocates the output.  cuda_lib.launch binds
each C launcher once and passes the caller's current stream.

  K1 mont_mul    -> kateth_tpu/fields/pallas_mont.py::_mont_mul_flat
  K2 pow_chain   -> pallas_mont.py::_pow_chain_flat
  K3 g1_ladder   -> pallas_mont.py::_g1_ladder_flat
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from .. import cuda_lib
from . import limbs as L
from .specs import FP, FR


def _field_id(spec: L.FieldSpec) -> int:
    if spec is FR:
        return 0
    if spec is FP:
        return 1
    raise ValueError(f"no kernel for field {spec.name}")


def _check_digits(spec: L.FieldSpec, shape) -> None:
    if len(shape) == 0 or shape[-1] != spec.n_digits:
        raise ValueError(f"{spec.name} operands are (..., {spec.n_digits}) digit planes")


# --- K1 ---------------------------------------------------------------------

def mont_mul_plain(spec: L.FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product by digit convolution and reduction."""
    return L.mont_reduce(spec, L._conv_digits(spec, a, b))


def mont_mul(spec: L.FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Montgomery product a b R^-1 mod N.  Most calls come from the
    plain point formulas, a few hundred lanes each, so the kernel path
    does the least host work it can: equal shapes skip broadcasting, and
    contiguous operands are taken as they are."""
    if a.is_cpu and b.is_cpu:
        return mont_mul_plain(spec, a, b)
    field = _field_id(spec)
    shape = a.shape
    if b.shape != shape:
        shape = torch.broadcast_shapes(shape, b.shape)
        a, b = a.expand(shape), b.expand(shape)
    _check_digits(spec, shape)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    dev = cuda_lib.check_cuda(a, b, out)
    lanes = a.numel() // spec.n_digits
    if lanes:
        cuda_lib.launch("mont_mul", dev, field, a.data_ptr(), b.data_ptr(), out.data_ptr(), lanes)
        cuda_lib.count_mont_mul_lanes(lanes)
    return out


# --- K2 ---------------------------------------------------------------------

#: the most steps a chain may have: csrc/pow_team.cuh PowChainArg holds this many
POW_MAX_STEPS = 128
#: the widest window a chain may use: 2^(w - 1) odd powers in the table
POW_MAX_WINDOW = 6


@dataclass(frozen=True)
class PowChain:
    """A sliding-window chain for a^e: acc = a^first, then for each step
    (s, d) acc = acc^(2^s) a^d (d odd, or 0 for no product).  The odd
    powers a^1, a^3, ..., a^table_max come first (a^2 and then one product
    each)."""

    window: int
    first: int
    steps: tuple[tuple[int, int], ...]

    @property
    def table_max(self) -> int:
        return max([self.first, *(d for _, d in self.steps)])

    @property
    def n_products(self) -> int:
        """Every Montgomery product of the chain, the table's included."""
        table = 0 if self.table_max == 1 else 1 + (self.table_max - 1) // 2
        return table + sum(s + (d != 0) for s, d in self.steps)

    def words(self) -> list[int]:
        """The steps as the launcher reads them: s | d << 10 (s <= 511,
        d <= 63)."""
        return [s | d << 10 for s, d in self.steps]


def _sliding_window(e: int, w: int) -> PowChain:
    """MSB first: a zero bit is a squaring; a one bit opens a window of at
    most w bits that ends in a one."""
    bits = bin(e)[2:]
    windows, i = [], 0  # (end bit, value)
    while i < len(bits):
        if bits[i] == "0":
            i += 1
            continue
        j = min(i + w, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        windows.append((j, int(bits[i:j], 2)))
        i = j
    (end, first), steps = windows[0], []
    for j, v in windows[1:]:
        steps.append((j - end, v))
        end = j
    if end < len(bits):
        steps.append((len(bits) - end, 0))
    return PowChain(w, first, tuple(steps))


@functools.cache
def pow_chain(e: int) -> PowChain:
    """The chain with the fewest products over windows 1 .. POW_MAX_WINDOW
    that fits the launcher (at most POW_MAX_STEPS steps; w = 5 always
    does for e < 2^512: a window opens at most every 5 bits)."""
    if not 1 <= e < 1 << 512:
        raise ValueError("pow_chain takes 1 <= e < 2^512")
    chains = [_sliding_window(e, w) for w in range(1, POW_MAX_WINDOW + 1)]
    return min((c for c in chains if len(c.steps) <= POW_MAX_STEPS), key=lambda c: c.n_products)


class _PowChainArg(ctypes.Structure):
    """The launcher's chain, laid out as csrc/pow_team.cuh PowChainArg."""

    _fields_ = [("n_steps", ctypes.c_int), ("first", ctypes.c_int), ("table_max", ctypes.c_int),
                ("step", ctypes.c_uint16 * POW_MAX_STEPS)]


@functools.cache
def _chain_arg(e: int) -> _PowChainArg:
    c = pow_chain(e)
    return _PowChainArg(len(c.steps), c.first, c.table_max, (ctypes.c_uint16 * POW_MAX_STEPS)(*c.words()))


def pow_const_plain(spec: L.FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e (e >= 1) by MSB-first square-and-multiply over the bits of e."""
    acc = a
    for bit in bin(e)[3:]:
        acc = mont_mul_plain(spec, acc, acc)
        if bit == "1":
            acc = mont_mul_plain(spec, acc, a)
    return acc


def pow_const(spec: L.FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a static exponent 1 <= e < 2^512 (Montgomery in and out);
    the kernel runs pow_chain(e), whose products give the plain chain's
    canonical digits."""
    if not 1 <= e < 1 << 512:
        raise ValueError("pow_const takes 1 <= e < 2^512")
    if a.device.type == "cpu":
        return pow_const_plain(spec, a, e)
    _check_digits(spec, a.shape)
    a = a.contiguous()
    out = torch.empty_like(a)
    dev = cuda_lib.check_cuda(a, out)
    lanes = math.prod(a.shape[:-1])
    if lanes:
        cuda_lib.launch(
            "pow_chain", dev, _field_id(spec), a.data_ptr(), out.data_ptr(), lanes,
            ctypes.addressof(_chain_arg(e)),
        )
    return out


# --- K3 ---------------------------------------------------------------------

def g1_scalar_mul_plain(point, scalar_digits: torch.Tensor):
    """The plain double-and-add ladder over all 256 scalar bits."""
    from ..curves import ops

    return ops.scalar_mul(ops.FP_FIELD, point, scalar_digits, n_bits=256)


def g1_scalar_mul(point, scalar_digits: torch.Tensor):
    """Per-lane G1 scalar multiply: point is a projective tuple of (..., 24)
    Montgomery coordinates, scalar_digits (..., 16) PLAIN Fr digits; all 256
    bits are walked MSB first (a leading zero bit doubles the identity)."""
    if scalar_digits.device.type == "cpu":
        return g1_scalar_mul_plain(point, scalar_digits)
    batch = torch.broadcast_shapes(scalar_digits.shape[:-1], *(c.shape[:-1] for c in point))
    pts = [c.expand(*batch, FP.n_digits).contiguous() for c in point]
    sc = scalar_digits.expand(*batch, FR.n_digits).contiguous()
    outs = [torch.empty_like(pts[0]) for _ in range(3)]
    dev = cuda_lib.check_cuda(*pts, sc, *outs)
    lanes = math.prod(batch)
    if lanes:
        cuda_lib.launch(
            "g1_ladder", dev, *(t.data_ptr() for t in pts), sc.data_ptr(),
            *(t.data_ptr() for t in outs), lanes,
        )
    return tuple(outs)
