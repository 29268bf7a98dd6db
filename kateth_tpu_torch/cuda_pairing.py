"""Wrappers for the pairing-module kernels K4 (Miller loop), K5 (hard part
of the final exponentiation) and K6 (G2 ladder), each beside its plain
version.

  K4 miller     -> kateth_tpu/pallas_pairing.py::_miller_flat
  K5 hard_part  -> kateth_tpu/pallas_pairing.py::_hard_part_flat
  K6 g2_ladder  -> kateth_tpu/pallas_pairing.py::_g2_ladder_flat

The kernels (csrc/miller.cu, csrc/hard_part.cu, csrc/g2_ladder.cu) read and
write the digit plane layout directly: G1 coordinates (..., 24), twist
coordinates (..., 2, 24), Fp12 values (..., 2, 3, 2, 24), so a wrapper only
broadcasts, makes the operands contiguous and allocates the output.  On a
CPU tensor a wrapper runs the plain version instead.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib, host
from .curves import ops
from .fields import fp2, fp12
from .fields.fp6 import fp2_mul_many
from .fields.specs import FP, FR

F2 = ops.FP2_FIELD
X_ABS = -host.BLS_X  # 0xd201000000010000


# ---------------------------------------------------------------------------
# K4: the Miller loop
# ---------------------------------------------------------------------------
#
# On the twist: T stays projective over Fp2; the line functions are
# evaluated at the G1 point twisted up by psi(x, y) = (x w^2, y w^3), giving
# sparse values A + (B xP) w^2 + (C yP) w^3 with A, B, C in Fp2:
#
#   tangent at T = (X, Y, Z):  A = 3X^3 - 2Y^2 Z,  B = -3X^2 Z,  C = 2YZ^2
#   chord through affine Q:    N = yq Z - Y, D = xq Z - X,
#                              A = N xq - D yq,  B = -N,  C = D
#
# Each line is the true line scaled by an element that the final
# exponentiation kills, so the pairing value is exact.

def _line_dbl(T):
    X, Y, Z = T
    x2, y2, yz = fp2_mul_many([(X, X), (Y, Y), (Y, Z)])
    x3, y2z, yz2, x2z = fp2_mul_many([(x2, X), (y2, Z), (yz, Z), (x2, Z)])
    a = fp2.sub(fp2.mul_small(x3, 3), fp2.mul_small(y2z, 2))
    b = fp2.neg(fp2.mul_small(x2z, 3))
    c = fp2.mul_small(yz2, 2)
    return a, b, c


def _line_add(T, q_aff):
    X, Y, Z = T
    xq, yq = q_aff
    nzy, dzx = fp2_mul_many([(yq, Z), (xq, Z)])
    n = fp2.sub(nzy, Y)
    d = fp2.sub(dzx, X)
    nxq, dyq = fp2_mul_many([(n, xq), (d, yq)])
    return fp2.sub(nxq, dyq), fp2.neg(n), d


def _merge_lines(l1, l2):
    """(a + b w^2 + c w^3)(a' + b' w^2 + c' w^3) as a dense Fp12:
    (aa' + xi cc', ab' + a'b, bb' | 0, ac' + a'c, bc' + b'c)."""
    a, b, c = l1
    a2, b2, c2 = l2
    aa, bb, cc, ab_s, ac_s, bc_s = fp2_mul_many(
        [
            (a, a2),
            (b, b2),
            (c, c2),
            (fp2.add(a, b), fp2.add(a2, b2)),
            (fp2.add(a, c), fp2.add(a2, c2)),
            (fp2.add(b, c), fp2.add(b2, c2)),
        ]
    )
    ab = fp2.sub(ab_s, fp2.add(aa, bb))
    ac = fp2.sub(ac_s, fp2.add(aa, cc))
    bc = fp2.sub(bc_s, fp2.add(bb, cc))
    r0 = torch.stack([fp2.add(aa, fp2.mul_by_xi(cc)), ab, bb], dim=-3)
    r1 = torch.stack([torch.zeros_like(aa), ac, bc], dim=-3)
    return torch.stack([r0, r1], dim=-4)


def miller_loop_affine_plain(xp, yp, xq, yq):
    """f_{|x|,Q}(psi(P)), conjugated for the negative x, as a scan over the
    63 bits of |x| after its leading one: the tangent line and the (bit-
    masked) chord line merged into one sparse factor, f = f^2 line."""
    batch = xp.shape[:-1]
    dev = xp.device
    xp2 = torch.stack([xp, torch.zeros_like(xp)], dim=-2)  # xP embedded in Fp2
    yp2 = torch.stack([yp, torch.zeros_like(yp)], dim=-2)
    one2 = fp2.one(batch, dev)
    zero2 = torch.zeros_like(one2)
    q_aff = (xq, yq)
    q_proj = (xq, yq, one2)
    f = fp12.one(batch, dev)
    T = q_proj
    for bit in bin(X_ABS)[3:]:
        a, b, c = _line_dbl(T)
        bxp, cyp = fp2_mul_many([(b, xp2), (c, yp2)])
        T = ops.pdouble(F2, T)
        if bit == "1":
            a2, b2, c2 = _line_add(T, q_aff)
            l2 = (a2, *fp2_mul_many([(b2, xp2), (c2, yp2)]))
            T = ops.padd(F2, T, q_proj)
        else:
            l2 = (one2, zero2, zero2)
        f = fp12.mul(fp12.sqr(f), _merge_lines((a, bxp, cyp), l2))
    return fp12.conj(f)


def miller_loop_affine(xp, yp, xq, yq):
    """Batched Miller loop on affine inputs (xp, yp: (..., 24) Fp;
    xq, yq: (..., 2, 24) Fp2).  Infinity masking is the caller's job."""
    if xp.device.type == "cpu":
        return miller_loop_affine_plain(xp, yp, xq, yq)
    batch = torch.broadcast_shapes(xp.shape[:-1], yp.shape[:-1], xq.shape[:-2], yq.shape[:-2])
    D = FP.n_digits
    xp = xp.expand(*batch, D).contiguous()
    yp = yp.expand(*batch, D).contiguous()
    xq = xq.expand(*batch, 2, D).contiguous()
    yq = yq.expand(*batch, 2, D).contiguous()
    out = torch.empty((*batch, 2, 3, 2, D), dtype=torch.int64, device=xp.device)
    dev = cuda_lib.check_cuda(xp, yp, xq, yq, out)
    lanes = math.prod(batch)
    if lanes:
        cuda_lib.launch(
            "miller", dev, xp.data_ptr(), yp.data_ptr(), xq.data_ptr(), yq.data_ptr(),
            out.data_ptr(), lanes,
        )
    return out


# ---------------------------------------------------------------------------
# K5: the hard part of the final exponentiation
# ---------------------------------------------------------------------------

def pow_x(f):
    """f^x for the negative BLS x on the cyclotomic subgroup: conj(f^|x|)."""
    return fp12.conj(fp12.pow_abs_cyc(f, X_ABS))


def hard_part_plain(f):
    """f^((x-1)^2 (x+p) (x^2+p^2-1) + 3) by the cyclotomic addition chain
    (conj is the inverse on the cyclotomic subgroup)."""
    t0 = fp12.mul(pow_x(f), fp12.conj(f))  # f^(x-1)
    t1 = fp12.mul(pow_x(t0), fp12.conj(t0))  # f^((x-1)^2)
    t2 = fp12.mul(pow_x(t1), fp12.frob(t1))  # ^(x+p)
    t3 = fp12.mul(  # ^(x^2+p^2-1)
        fp12.mul(pow_x(pow_x(t2)), fp12.frob(fp12.frob(t2))), fp12.conj(t2)
    )
    return fp12.mul(t3, fp12.mul(fp12.cyc_sqr(f), f))  # * f^3


def hard_part(f):
    """The hard part for f (..., 2, 3, 2, 24) after the easy part: kernel
    K5 (a block of threads per lane) on a CUDA tensor.  f must lie in the
    cyclotomic subgroup, as both versions square by Granger-Scott."""
    if f.device.type == "cpu":
        return hard_part_plain(f)
    if f.shape[-4:] != (2, 3, 2, FP.n_digits):
        raise ValueError("hard_part takes Fp12 digit planes (..., 2, 3, 2, 24)")
    f = f.contiguous()
    out = torch.empty_like(f)
    dev = cuda_lib.check_cuda(f, out)
    lanes = math.prod(f.shape[:-4])
    if lanes:
        cuda_lib.launch("hard_part", dev, f.data_ptr(), out.data_ptr(), lanes)
    return out


# ---------------------------------------------------------------------------
# K6: the G2 ladder
# ---------------------------------------------------------------------------

def g2_scalar_mul_plain(point, scalar_digits: torch.Tensor):
    """The plain double-and-add ladder over all 256 scalar bits."""
    return ops.scalar_mul(F2, point, scalar_digits, n_bits=256)


def g2_scalar_mul(point, scalar_digits: torch.Tensor):
    """Per-lane G2 scalar multiply: point is a projective tuple of
    (..., 2, 24) Montgomery Fp2 coordinates, scalar_digits (..., 16) PLAIN
    Fr digits; all 256 bits are walked MSB first."""
    if scalar_digits.device.type == "cpu":
        return g2_scalar_mul_plain(point, scalar_digits)
    D = FP.n_digits
    batch = torch.broadcast_shapes(scalar_digits.shape[:-1], *(c.shape[:-2] for c in point))
    pts = [c.expand(*batch, 2, D).contiguous() for c in point]
    sc = scalar_digits.expand(*batch, FR.n_digits).contiguous()
    outs = [torch.empty_like(pts[0]) for _ in range(3)]
    dev = cuda_lib.check_cuda(*pts, sc, *outs)
    lanes = math.prod(batch)
    if lanes:
        cuda_lib.launch(
            "g2_ladder", dev, *(t.data_ptr() for t in pts), sc.data_ptr(),
            *(t.data_ptr() for t in outs), lanes,
        )
    return tuple(outs)
