"""Complete-formula curve arithmetic, generic over Fp (G1) and Fp2 (G2).

The complete projective formulas for short Weierstrass curves with a = 0
(Renes-Costello-Batina 2016, Algorithms 7 and 9) are one straight-line
program valid for every input (identity, doubling, inverse pairs), so
batched point operations need no branches.

Points are homogeneous projective triples (X, Y, Z): x = X/Z, y = Y/Z, the
identity is (0 : 1 : 0).  Coordinates are digit planes: (..., D) for Fp and
(..., 2, D) for Fp2.  The independent products of each formula phase are
stacked into one batched multiply.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..fields import fp2, fp6
from ..fields import limbs as L
from ..fields.specs import FP


@dataclass(frozen=True, eq=False)
class CurveField:
    """Field adapter giving the curve formulas a uniform interface."""

    name: str
    fdim: int  # trailing field dims of one coordinate: 1 (Fp) or 2 (Fp2)
    add: Callable
    sub: Callable
    neg: Callable
    mul_many: Callable  # list[(a, b)] -> list of products, one batched call
    smallmul_many: Callable  # list[(a, k, apply_xi)] -> list of k (xi) a
    zero: Callable  # (shape, device) -> zero element
    one: Callable  # (shape, device) -> one (Montgomery)
    is_zero: Callable
    inv: Callable

    def expand(self, mask: torch.Tensor) -> torch.Tensor:
        """Broadcast a batch-shaped mask over the field's trailing dims."""
        return mask.reshape(*mask.shape, *([1] * self.fdim))


def _stack_pairs(pairs):
    shapes = [
        a.shape if a.shape == b.shape else torch.broadcast_shapes(a.shape, b.shape)
        for a, b in pairs
    ]
    lhs = torch.stack([a.expand(s) for (a, _), s in zip(pairs, shapes)])
    rhs = torch.stack([b.expand(s) for (_, b), s in zip(pairs, shapes)])
    return lhs, rhs


def _many(op, pairs):
    """op over all (a, b) pairs as one stacked call."""
    out = op(*_stack_pairs(pairs))
    return [out[i] for i in range(len(pairs))]


def _smallmul_many(items, xi: Callable | None):
    """[(x, k, apply_xi)] -> [k (xi) x], one xi pass and one widened
    multiply for all items."""
    xs = [x for x, _, _ in items]
    if xi is not None:
        idx = [i for i, (_, _, f) in enumerate(items) if f]
        if idx:
            xied = xi(torch.stack([xs[i] for i in idx]))
            for j, i in enumerate(idx):
                xs[i] = xied[j]
    st = torch.stack(xs)
    ks = np.array([k for _, k, _ in items], dtype=np.int64).reshape(-1, *([1] * (st.ndim - 2)))
    out = L.mul_small(FP, st, ks)
    return [out[i] for i in range(len(items))]


def _fp_one(shape=(), device=None):
    return FP.tensor("one_mont", device or "cpu").expand(*shape, FP.n_digits).clone()


FP_FIELD = CurveField(
    name="fp",
    fdim=1,
    add=lambda a, b: L.add(FP, a, b),
    sub=lambda a, b: L.sub(FP, a, b),
    neg=lambda a: L.neg(FP, a),
    mul_many=lambda pairs: _many(lambda a, b: L.mont_mul(FP, a, b), pairs),
    smallmul_many=lambda items: _smallmul_many(items, None),
    zero=lambda shape=(), device=None: torch.zeros(
        (*shape, FP.n_digits), dtype=torch.int64, device=device
    ),
    one=_fp_one,
    is_zero=L.is_zero,
    inv=lambda a: L.inv(FP, a),
)

FP2_FIELD = CurveField(
    name="fp2",
    fdim=2,
    add=fp2.add,
    sub=fp2.sub,
    neg=fp2.neg,
    mul_many=fp6.fp2_mul_many,
    smallmul_many=lambda items: _smallmul_many(items, fp2.mul_by_xi),
    zero=fp2.zero,
    one=fp2.one,
    is_zero=fp2.is_zero,
    inv=fp2.inv,
)


# ---------------------------------------------------------------------------
# point ops
# ---------------------------------------------------------------------------

def identity(F: CurveField, shape=(), device=None):
    """(0 : 1 : 0)."""
    return (F.zero(shape, device), F.one(shape, device), F.zero(shape, device))


def is_identity(F: CurveField, p):
    return F.is_zero(p[2])


def padd(F: CurveField, p, q):
    """Complete projective addition (RCB16 Algorithm 7, a = 0)."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    s1, s2, s3, s4, s5, s6 = _many(
        F.add, [(X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2), (X1, Z1), (X2, Z2)]
    )
    m0, m1, m2, m3, m4, m5 = F.mul_many(
        [(X1, X2), (Y1, Y2), (Z1, Z2), (s1, s2), (s3, s4), (s5, s6)]
    )
    s01, s12, s02, d0 = _many(F.add, [(m0, m1), (m1, m2), (m0, m2), (m0, m0)])
    t3, t4, ty = _many(F.sub, [(m3, s01), (m4, s12), (m5, s02)])
    (t2,) = F.smallmul_many([(m2, 12, True)])  # b3 Z1 Z2
    t0, z3 = _many(F.add, [(d0, m0), (m1, t2)])  # 3 X1 X2 ; m1 + b3 Z1 Z2
    t1 = F.sub(m1, t2)
    (y3,) = F.smallmul_many([(ty, 12, True)])
    n0, n1, n2, n3, n4, n5 = F.mul_many(
        [(t4, y3), (t3, t1), (y3, t0), (t1, z3), (t0, t3), (z3, t4)]
    )
    X3 = F.sub(n1, n0)
    Y3, Z3 = _many(F.add, [(n3, n2), (n5, n4)])
    return (X3, Y3, Z3)


def pdouble(F: CurveField, p):
    """Complete projective doubling (RCB16 Algorithm 9, a = 0)."""
    X, Y, Z = p
    a, bb, c, d = F.mul_many([(Y, Y), (Y, Z), (Z, Z), (X, Y)])
    # e = b3 Z^2 ; t2 = 3 b3 Z^2 ; a8 = 8 Y^2
    e, t2, a8 = F.smallmul_many([(c, 12, True), (c, 36, True), (a, 8, False)])
    t0 = F.sub(a, t2)
    y3a = F.add(a, e)
    n0, n1, n2, n3 = F.mul_many([(e, a8), (bb, a8), (t0, y3a), (t0, d)])
    X3, Y3 = _many(F.add, [(n3, n3), (n0, n2)])
    return (X3, Y3, n1)


def pneg(F: CurveField, p):
    return (p[0], F.neg(p[1]), p[2])


def pselect(F: CurveField, mask, p, q):
    """Elementwise point select: mask ? p : q (mask shape = batch shape)."""
    m = F.expand(mask)
    return tuple(torch.where(m, a, b) for a, b in zip(p, q))


def scalar_bits_msb(scalar_digits: torch.Tensor, n_bits: int = 255) -> torch.Tensor:
    """Plain Fr digit planes (..., 16) -> (n_bits, ...) bool bits, most
    significant first."""
    shifts = torch.arange(L.DIGIT_BITS, device=scalar_digits.device)
    bits = (scalar_digits[..., :, None] >> shifts) & 1  # (..., 16, 16) LSB first
    bits = bits.reshape(*scalar_digits.shape[:-1], -1)[..., :n_bits].flip(-1)
    return bits.movedim(-1, 0).bool()


def scalar_mul(F: CurveField, p, scalar_digits: torch.Tensor, n_bits: int = 255):
    """Double-and-add with masked adds over n_bits fixed steps (the plain
    ladder).  scalar_digits are PLAIN (non-Montgomery) Fr digits."""
    bits = scalar_bits_msb(scalar_digits, n_bits)
    batch = torch.broadcast_shapes(p[0].shape[: p[0].ndim - F.fdim], scalar_digits.shape[:-1])
    acc = identity(F, batch, scalar_digits.device)
    p_b = tuple(c.expand(*batch, *c.shape[c.ndim - F.fdim :]) for c in p)
    for bit in bits:
        acc = pdouble(F, acc)
        acc = pselect(F, bit, padd(F, acc, p_b), acc)
    return acc


def to_affine(F: CurveField, p):
    """Projective -> affine (x, y); the identity maps to (0, 0)."""
    X, Y, Z = p
    zinv = F.inv(Z)  # zero -> zero
    x, y = F.mul_many([(X, zinv), (Y, zinv)])
    return (x, y)
