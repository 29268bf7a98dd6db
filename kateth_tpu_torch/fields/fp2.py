"""Fp2 = Fp[u]/(u^2+1) on digit planes.

An Fp2 element is a ``(..., 2, D)`` int64 tensor (component axis just
before the digit axis), Montgomery form per component.  The independent
base-field products of each operation are stacked into one batched Fp
multiply.
"""

from __future__ import annotations

import numpy as np
import torch

from . import limbs as L
from .specs import FP


def zero(shape=(), device=None) -> torch.Tensor:
    return torch.zeros((*shape, 2, FP.n_digits), dtype=torch.int64, device=device)


def one(shape=(), device=None) -> torch.Tensor:
    out = zero(shape, device)
    out[..., 0, :] = FP.tensor("one_mont", out.device)
    return out


def from_ints(c0: int, c1: int) -> np.ndarray:
    return np.stack([FP.from_int(c0), FP.from_int(c1)])


def to_ints(a) -> tuple[int, int]:
    a = np.asarray(a)
    return (FP.to_int(a[..., 0, :]), FP.to_int(a[..., 1, :]))


def add(a, b):
    return L.add(FP, a, b)


def sub(a, b):
    return L.sub(FP, a, b)


def neg(a):
    return L.neg(FP, a)


def conj(a):
    return torch.stack([a[..., 0, :], L.neg(FP, a[..., 1, :])], dim=-2)


def mul(a, b):
    """Karatsuba: 3 Fp products in one batched multiply."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    s = L.add(FP, torch.stack([a0, b0]), torch.stack([a1, b1]))  # a0 + a1, b0 + b1
    p = L.mont_mul(FP, torch.stack([a0, a1, s[0]]), torch.stack([b0, b1, s[1]]))
    t01 = L.add(FP, p[0], p[1])
    c = L.sub(FP, torch.stack([p[0], p[2]]), torch.stack([p[1], t01]))
    return torch.stack([c[0], c[1]], dim=-2)


def sqr(a):
    """(a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u: 2 Fp products."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    lhs = torch.stack([L.add(FP, a0, a1), a0])
    rhs = torch.stack([L.sub(FP, a0, a1), a1])
    p = L.mont_mul(FP, lhs, rhs)
    return torch.stack([p[0], L.add(FP, p[1], p[1])], dim=-2)


def mul_by_xi(a):
    """Multiply by the sextic non-residue xi = 1 + u."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return torch.stack([L.sub(FP, a0, a1), L.add(FP, a0, a1)], dim=-2)


def mul_small(a, k: int):
    return L.mul_small(FP, a, k)


def inv(a):
    """1/(a0 + a1 u) = (a0 - a1 u)/(a0^2 + a1^2); zero -> zero."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    sq = L.mont_mul(FP, torch.stack([a0, a1]), torch.stack([a0, a1]))
    ninv = L.inv(FP, L.add(FP, sq[0], sq[1]))
    p = L.mont_mul(FP, torch.stack([a0, L.neg(FP, a1)]), torch.stack([ninv, ninv]))
    return torch.stack([p[0], p[1]], dim=-2)


def is_zero(a):
    return (a == 0).all(-1).all(-1)
