"""Fp6 = Fp2[v]/(v^3 - xi) on digit planes, xi = 1 + u.

An Fp6 element is a ``(..., 3, 2, D)`` int64 tensor.  All 18 base-field
products of an Fp6 multiply (6 Fp2 Karatsuba products) run as one batched
Montgomery multiply.
"""

from __future__ import annotations

import numpy as np
import torch

from . import limbs as L
from . import fp2
from .specs import FP


def from_ints(a) -> np.ndarray:
    """((c00, c01), (c10, c11), (c20, c21)) ints -> digit planes (3, 2, D)."""
    return np.stack([fp2.from_ints(*a[i]) for i in range(3)])


def to_ints(x):
    x = np.asarray(x)
    return tuple(fp2.to_ints(x[..., i, :, :]) for i in range(3))


def add(a, b):
    return L.add(FP, a, b)


def sub(a, b):
    return L.sub(FP, a, b)


def neg(a):
    return L.neg(FP, a)


def mul_by_v(a):
    """(a0, a1, a2) -> (xi a2, a0, a1)."""
    return torch.cat([fp2.mul_by_xi(a[..., 2:3, :, :]), a[..., 0:2, :, :]], dim=-3)


def fp2_mul_many(pairs):
    """Stacked Fp2 products: one Karatsuba multiply for all pairs."""
    shapes = [torch.broadcast_shapes(a.shape, b.shape) for a, b in pairs]
    A = torch.stack([a.expand(s) for (a, _), s in zip(pairs, shapes)])
    B = torch.stack([b.expand(s) for (_, b), s in zip(pairs, shapes)])
    out = fp2.mul(A, B)
    return [out[i] for i in range(len(pairs))]


def mul(a, b):
    """Karatsuba over Fp2: t_i = a_i b_i and the three cross sums s_i, as
    one stacked Fp2 multiply (18 Fp products); each linear step is one
    stacked add or sub.
    c0 = t0 + xi (s0 - t1 - t2), c1 = s1 - t0 - t1 + xi t2, c2 = s2 - t0 - t2 + t1."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    b0, b1, b2 = b[..., 0, :, :], b[..., 1, :, :], b[..., 2, :, :]
    s = fp2.add(torch.stack([a1, a0, a0, b1, b0, b0]), torch.stack([a2, a1, a2, b2, b1, b2]))
    p = fp2.mul(torch.stack([a0, a1, a2, s[0], s[1], s[2]]), torch.stack([b0, b1, b2, s[3], s[4], s[5]]))
    t0, t1, t2 = p[0], p[1], p[2]
    u = fp2.add(torch.stack([t1, t0, t0]), torch.stack([t2, t1, t2]))
    v = fp2.sub(p[3:6], u)
    xi = fp2.mul_by_xi(torch.stack([v[0], t2]))
    c = fp2.add(torch.stack([t0, v[1], v[2]]), torch.stack([xi[0], xi[1], t1]))
    return torch.stack([c[0], c[1], c[2]], dim=-3)


def inv(a):
    """Fp6 inversion via the adjoint formula (zero -> zero)."""
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    # c0 = a0^2 - xi a1 a2 ; c1 = xi a2^2 - a0 a1 ; c2 = a1^2 - a0 a2
    p = fp2_mul_many([(a0, a0), (a1, a2), (a2, a2), (a0, a1), (a1, a1), (a0, a2)])
    c0 = fp2.sub(p[0], fp2.mul_by_xi(p[1]))
    c1 = fp2.sub(fp2.mul_by_xi(p[2]), p[3])
    c2 = fp2.sub(p[4], p[5])
    q = fp2_mul_many([(a2, c1), (a1, c2), (a0, c0)])
    tinv = fp2.inv(fp2.add(fp2.mul_by_xi(fp2.add(q[0], q[1])), q[2]))
    return torch.stack(fp2_mul_many([(c0, tinv), (c1, tinv), (c2, tinv)]), dim=-3)
