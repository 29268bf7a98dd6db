"""Fp12 = Fp6[w]/(w^2 - v) on digit planes.

An Fp12 element is a ``(..., 2, 3, 2, D)`` int64 tensor.  The 54 base-field
products of a dense multiply run as one stacked Montgomery multiply.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import host
from . import limbs as L
from . import fp2, fp6
from .specs import FP


def zero(shape=(), device=None) -> torch.Tensor:
    return torch.zeros((*shape, 2, 3, 2, FP.n_digits), dtype=torch.int64, device=device)


def one(shape=(), device=None) -> torch.Tensor:
    out = zero(shape, device)
    out[..., 0, 0, 0, :] = FP.tensor("one_mont", out.device)
    return out


def from_ints(a) -> np.ndarray:
    """Nested (Fp6, Fp6) int tuples -> digit planes (2, 3, 2, D)."""
    return np.stack([fp6.from_ints(a[0]), fp6.from_ints(a[1])])


def to_ints(x):
    x = np.asarray(x)
    return (fp6.to_ints(x[..., 0, :, :, :]), fp6.to_ints(x[..., 1, :, :, :]))


def conj(a):
    """a0 - a1 w (== Frobenius^6; the inverse on the cyclotomic subgroup)."""
    return torch.cat([a[..., 0:1, :, :, :], L.neg(FP, a[..., 1:2, :, :, :])], dim=-4)


def mul(a, b):
    """Dense multiply: t0 = a0 b0, t1 = a1 b1, s = (a0 + a1)(b0 + b1) as
    one stacked Fp6 multiply (54 base rows); c0 = t0 + v t1,
    c1 = s - t0 - t1."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    b0, b1 = b[..., 0, :, :, :], b[..., 1, :, :, :]
    X = torch.stack([a0, a1, fp6.add(a0, a1)], dim=-4)
    Y = torch.stack([b0, b1, fp6.add(b0, b1)], dim=-4)
    P = fp6.mul(X, Y)
    t0, t1, s = P[..., 0, :, :, :], P[..., 1, :, :, :], P[..., 2, :, :, :]
    c0 = fp6.add(t0, fp6.mul_by_v(t1))
    c1 = fp6.sub(s, fp6.add(t0, t1))
    return torch.stack([c0, c1], dim=-4)


def sqr(a):
    """Complex squaring: t = a0 a1, c0 = (a0 + a1)(a0 + v a1) - t - v t,
    c1 = 2 t."""
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    X = torch.stack([a0, fp6.add(a0, a1)], dim=-4)
    Y = torch.stack([a1, fp6.add(a0, fp6.mul_by_v(a1))], dim=-4)
    P = fp6.mul(X, Y)
    t, s = P[..., 0, :, :, :], P[..., 1, :, :, :]
    c0 = fp6.sub(s, fp6.add(t, fp6.mul_by_v(t)))
    return torch.stack([c0, fp6.add(t, t)], dim=-4)


def inv(a):
    """1/(a0 + a1 w) = (a0 - a1 w)/(a0^2 - v a1^2); zero -> zero."""
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    sq = fp6.mul(torch.stack([a0, a1], dim=-4), torch.stack([a0, a1], dim=-4))
    t = fp6.sub(sq[..., 0, :, :, :], fp6.mul_by_v(sq[..., 1, :, :, :]))
    tinv = fp6.inv(t)
    return fp6.mul(
        torch.stack([a0, fp6.neg(a1)], dim=-4),
        torch.stack([tinv, tinv], dim=-4),
    )


def is_one(a):
    return eq(a, one(device=a.device))


def eq(a, b):
    return (a == b).flatten(-4).all(-1)


def select(mask, a, b):
    """mask ? a : b with a batch-shaped mask."""
    return torch.where(mask[..., None, None, None, None], a, b)


# --- Frobenius ---------------------------------------------------------------

#: gamma_i = xi^(i (p-1)/6), i = 1..5, as (5, 2, D) Montgomery digit planes
GAMMA = np.stack([fp2.from_ints(*g) for g in host.GAMMA1])
#: frob's twist of the six Fp2 coordinates: (1, gamma_2, gamma_4, gamma_1,
#: gamma_3, gamma_5), made once per device
_FROB_TWIST = L.DeviceConstants(
    lambda _: np.stack([fp2.from_ints(1, 0), GAMMA[1], GAMMA[3], GAMMA[0], GAMMA[2], GAMMA[4]]))


def frob(a):
    """x -> x^p: conjugate every Fp2 coordinate, then twist the coordinates
    (c0.1, c0.2, c1.0, c1.1, c1.2) by gamma (2, 4, 1, 3, 5)."""
    c = torch.cat([a[..., 0:1, :], L.neg(FP, a[..., 1:2, :])], dim=-2)
    flat = c.reshape(*c.shape[:-4], 6, 2, c.shape[-1])
    return fp2.mul(flat, _FROB_TWIST.get(None, a.device)).reshape(a.shape)


# --- cyclotomic subgroup ops -------------------------------------------------

def cyc_sqr(a):
    """Granger-Scott squaring, exact on the cyclotomic subgroup (after the
    easy part of the final exponentiation): 9 Fp2 squares."""
    a0, a1, a2 = a[..., 0, 0, :, :], a[..., 0, 1, :, :], a[..., 0, 2, :, :]
    b0, b1, b2 = a[..., 1, 0, :, :], a[..., 1, 1, :, :], a[..., 1, 2, :, :]
    lo = torch.stack([b1, a2, b2], dim=-3)
    hi = torch.stack([a0, b0, a1], dim=-3)
    q = fp2.sqr(torch.cat([lo, hi, fp2.add(lo, hi)], dim=-3))
    tl, th, ts = q[..., 0:3, :, :], q[..., 3:6, :, :], q[..., 6:9, :, :]
    cross = fp2.sub(ts, fp2.add(tl, th))  # 2 a0 b1, 2 a2 b0, 2 a1 b2
    u = fp2.add(fp2.mul_by_xi(tl), th)
    d0 = fp2.sub(u, torch.stack([a0, a1, a2], dim=-3))
    c0n = fp2.add(fp2.add(d0, d0), u)
    t = torch.cat([fp2.mul_by_xi(cross[..., 2:3, :, :]), cross[..., 0:2, :, :]], dim=-3)
    d1 = fp2.add(t, torch.stack([b0, b1, b2], dim=-3))
    c1n = fp2.add(fp2.add(d1, d1), t)
    return torch.stack([c0n, c1n], dim=-4)


def pow_abs_cyc(a, e: int):
    """a^e for a static e >= 1, a in the cyclotomic subgroup: runs of zero
    bits are Granger-Scott squarings, each set bit one dense multiply."""
    if e < 1:
        raise ValueError("pow_abs_cyc takes e >= 1")
    acc = a
    for bit in bin(e)[3:]:
        acc = cyc_sqr(acc)
        if bit == "1":
            acc = mul(acc, a)
    return acc
