"""The BLS12-381 pairing check.

`miller_loop` takes projective G1 and G2 points, maps them to affine (with
the generators standing in for infinity) and runs the Miller loop through
`cuda_pairing.miller_loop_affine` (kernel K4 on a CUDA tensor).
`final_exponentiation` runs the easy part f^((p^6-1)(p^2+1)) here and the
hard part through `cuda_pairing.hard_part` (kernel K5), computing the
scaled exponent 3 (p^4 - p^2 + 1)/r; the factor 3 is invisible to the
check since the reduced value has order dividing r.  Infinity inputs give
a Miller value of one.
"""

from __future__ import annotations

import torch

from . import cuda_pairing
from .curves import g1 as g1mod
from .curves import g2 as g2mod
from .curves import ops
from .fields import fp12


def miller_loop(p_g1, q_g2):
    """f_{|x|,Q}(psi(P)), conjugated for the negative BLS parameter.

    p_g1: projective G1 coordinates (..., 24) each; q_g2: projective twist
    coordinates (..., 2, 24) each.  Infinity inputs give one."""
    dev = p_g1[0].device
    p_inf = ops.is_identity(ops.FP_FIELD, p_g1)
    q_inf = ops.is_identity(ops.FP2_FIELD, q_g2)
    g1 = tuple(g.expand_as(c) for g, c in zip(g1mod.generator(dev), p_g1))
    g2 = tuple(g.expand_as(c) for g, c in zip(g2mod.generator(dev), q_g2))
    xp, yp = ops.to_affine(ops.FP_FIELD, ops.pselect(ops.FP_FIELD, p_inf, g1, p_g1))
    xq, yq = ops.to_affine(ops.FP2_FIELD, ops.pselect(ops.FP2_FIELD, q_inf, g2, q_g2))
    f = cuda_pairing.miller_loop_affine(xp, yp, xq, yq)
    return fp12.select(p_inf | q_inf, fp12.one(device=dev).expand_as(f), f)


def final_exponentiation(f):
    """f^(3 (p^12 - 1)/r): the easy part, then the cyclotomic hard part."""
    f = fp12.mul(fp12.conj(f), fp12.inv(f))
    f = fp12.mul(fp12.frob(fp12.frob(f)), f)
    return cuda_pairing.hard_part(f)


def verify_pairings(a, b):
    """e(a1, a2) == e(b1, b2) as final_exp(ml(-a1, a2) ml(b1, b2)) == 1;
    batched over the leading dims of the points."""
    (a1, a2), (b1, b2) = a, b
    p = tuple(torch.stack([x, y]) for x, y in zip(ops.pneg(ops.FP_FIELD, a1), b1))
    q = tuple(torch.stack([x, y]) for x, y in zip(a2, b2))
    fs = miller_loop(p, q)
    return fp12.is_one(final_exponentiation(fp12.mul(fs[0], fs[1])))
