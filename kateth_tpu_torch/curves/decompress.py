"""Batched G1 and G2 decompression (Zcash 48- and 96-byte formats) on
digit planes.

* flag bits in byte 0: 0x80 compressed (must be set), 0x40 infinity,
  0x20 sign (y is the lexicographically larger root);
* infinity requires sign == 0 and every x bit zero;
* x must be canonical (< p);
* y = (x^3 + 4)^((p+1)/4) (p = 3 mod 4), valid iff y^2 == x^3 + 4;
* subgroup membership: r P == identity, by the G1 ladder (kernel K3).

Everything is a mask; the caller raises KzgError from the returned
validity planes.  The square root is one pow-chain kernel (K2) launch.

G2 follows the same rules over Fp2 = Fp[u]/(u^2 + 1) with the twist's
b = 4(1 + u): the 96 bytes are x.c1 || x.c0, with the flags in byte 0 of
x.c1; both components must be canonical; the square root is Adj and
Rodriguez-Henriquez's Algorithm 9, two square-and-multiply chains over the
Fp2 products of fields/fp2.py; the subgroup check r P is one launch of the
G2 ladder (kernel K6).  G2 points are decoded once per setup load (65 of
them at mainnet), so the chains stay plain.
"""

from __future__ import annotations

import torch

from .. import cuda_pairing
from ..fields import cuda_mont, fp2
from ..fields import limbs as L
from ..fields.specs import FP, FR
from . import compress, ops

F1 = ops.FP_FIELD
F2 = ops.FP2_FIELD

_SQRT_EXP = (FP.modulus + 1) // 4
_FOUR_MONT = FP.from_int(4)  # the curve's b, Montgomery form
_R_DIGITS = L.int_to_digits(FR.modulus, FR.n_digits)


def g1_decompress_nosub(comp_bytes: torch.Tensor):
    """(B, 48) uint8 -> (point, ok_encoding (B,), ok_curve (B,)) without
    the subgroup check.  Invalid lanes hold garbage masked by the planes;
    infinity encodings decode to the identity (0 : 1 : 0)."""
    dev = comp_bytes.device
    flags = comp_bytes[..., 0].to(torch.int64)
    c_flag = (flags >> 7) & 1
    is_inf = ((flags >> 6) & 1) == 1
    s_flag = (flags >> 5) & 1

    xb = comp_bytes.clone()
    xb[..., 0] = (flags & 0x1F).to(torch.uint8)
    x_plain = L.be_bytes_to_digits(FP, xb)
    canonical = L.lt_modulus(FP, x_plain)
    inf_ok = (s_flag == 0) & L.is_zero(x_plain)
    ok_encoding = (c_flag == 1) & torch.where(is_inf, inf_ok, canonical)

    x = L.to_mont(FP, x_plain)
    x3 = L.mont_mul(FP, L.mont_sqr(FP, x), x)
    t = L.add(FP, x3, _CONSTANTS.get("four_mont", dev).expand_as(x3))
    y = L.pow_const(FP, t, _SQRT_EXP)
    ok_curve = L.eq(L.mont_sqr(FP, y), t) | is_inf

    # the sign flag picks the larger or the smaller root
    y_large = compress.gt_half(L.from_mont(FP, y))
    y_sel = torch.where((y_large != (s_flag == 1))[..., None], L.neg(FP, y), y)

    batch = flags.shape
    inf_mask = is_inf[..., None]
    point = (
        torch.where(inf_mask, F1.zero(batch, dev), x),
        torch.where(inf_mask, F1.one(batch, dev), y_sel),
        torch.where(inf_mask, F1.zero(batch, dev), F1.one(batch, dev)),
    )
    return point, ok_encoding, ok_curve


def group_order(device) -> torch.Tensor:
    """r as plain Fr digits (16,) on `device`: the scalar of the subgroup
    checks."""
    return _CONSTANTS.get("r", device)


def subgroup_check(point) -> torch.Tensor:
    """r P == identity (identity lanes pass trivially)."""
    batch = point[0].shape[:-1]
    r = group_order(point[0].device).expand(*batch, FR.n_digits)
    return ops.is_identity(F1, cuda_mont.g1_scalar_mul(point, r))


def g1_decompress(comp_bytes: torch.Tensor):
    """(B, 48) uint8 -> (point (X, Y, Z) each (B, 24) Montgomery,
    ok_encoding (B,), ok_curve (B,), ok_subgroup (B,))."""
    point, ok_encoding, ok_curve = g1_decompress_nosub(comp_bytes)
    return point, ok_encoding, ok_curve, subgroup_check(point)


# ---------------------------------------------------------------------------
# G2 (96-byte format)
# ---------------------------------------------------------------------------

#: the twist's b = 4(1 + u), Montgomery form per component
_B2_MONT = fp2.from_ints(4, 4)
#: -1 in Fp (Montgomery): the alpha == -1 test of the Fp2 square root
_NEG_ONE_MONT = FP.from_int(FP.modulus - 1)

#: the constants above, made once per device
_CONSTANTS = L.DeviceConstants({
    "four_mont": _FOUR_MONT, "r": _R_DIGITS, "b2_mont": _B2_MONT,
    "neg_one_mont": _NEG_ONE_MONT}.__getitem__)


def _fp2_pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e over Fp2 planes (..., 2, D) for a static e >= 1: MSB-first
    square-and-multiply, the multiply skipped on a zero bit."""
    if e < 1:
        raise ValueError("the exponent must be positive")
    acc = a
    for bit in bin(e)[3:]:
        acc = fp2.sqr(acc)
        if bit == "1":
            acc = fp2.mul(acc, a)
    return acc


def _fp2_sqrt(a: torch.Tensor) -> torch.Tensor:
    """A candidate square root over Fp2 for p = 3 mod 4 (Adj and
    Rodriguez-Henriquez, Algorithm 9):

        a1 = a^((p-3)/4); x0 = a1 a; alpha = a1 x0
        alpha == -1 ? y = u x0 : y = (1 + alpha)^((p-1)/2) x0

    Both candidates are computed and a mask selects; the caller checks
    y^2 == a."""
    a1 = _fp2_pow_const(a, (FP.modulus - 3) // 4)
    x0 = fp2.mul(a1, a)
    alpha = fp2.mul(a1, x0)
    ux0 = torch.stack([L.neg(FP, x0[..., 1, :]), x0[..., 0, :]], dim=-2)  # u x0
    is_neg_one = L.eq(alpha[..., 0, :], _CONSTANTS.get("neg_one_mont", a.device)) & (
        L.is_zero(alpha[..., 1, :])
    )
    b = _fp2_pow_const(fp2.add(fp2.one(alpha.shape[:-2], a.device), alpha), (FP.modulus - 1) // 2)
    return torch.where(is_neg_one[..., None, None], ux0, fp2.mul(b, x0))


def g2_decompress_nosub(comp_bytes: torch.Tensor):
    """(B, 96) uint8 -> (point (X, Y, Z) each (B, 2, 24) Montgomery,
    ok_encoding (B,), ok_curve (B,)) without the subgroup check; infinity
    encodings decode to the identity (0 : 1 : 0)."""
    dev = comp_bytes.device
    flags = comp_bytes[..., 0].to(torch.int64)
    c_flag = (flags >> 7) & 1
    is_inf = ((flags >> 6) & 1) == 1
    s_flag = (flags >> 5) & 1

    b1 = comp_bytes[..., :48].clone()
    b1[..., 0] = (flags & 0x1F).to(torch.uint8)
    x1_plain = L.be_bytes_to_digits(FP, b1)  # the c1 component
    x0_plain = L.be_bytes_to_digits(FP, comp_bytes[..., 48:])
    canonical = L.lt_modulus(FP, x0_plain) & L.lt_modulus(FP, x1_plain)
    inf_ok = (s_flag == 0) & L.is_zero(x0_plain) & L.is_zero(x1_plain)
    ok_encoding = (c_flag == 1) & torch.where(is_inf, inf_ok, canonical)

    x = L.to_mont(FP, torch.stack([x0_plain, x1_plain], dim=-2))
    t = fp2.add(fp2.mul(fp2.sqr(x), x), _CONSTANTS.get("b2_mont", dev))
    y = _fp2_sqrt(t)
    ok_curve = L.eq(fp2.sqr(y), t).all(-1) | is_inf

    # the sign flag picks the larger or the smaller root
    flip = compress.fp2_is_larger(L.from_mont(FP, y)) != (s_flag == 1)
    y_sel = torch.where(flip[..., None, None], fp2.neg(y), y)

    batch = flags.shape
    inf_mask = is_inf[..., None, None]
    point = (
        torch.where(inf_mask, F2.zero(batch, dev), x),
        torch.where(inf_mask, F2.one(batch, dev), y_sel),
        torch.where(inf_mask, F2.zero(batch, dev), F2.one(batch, dev)),
    )
    return point, ok_encoding, ok_curve


def g2_subgroup_check(point) -> torch.Tensor:
    """r P == identity over G2, one G2 ladder (K6) launch for the batch."""
    batch = point[0].shape[:-2]
    r = group_order(point[0].device).expand(*batch, FR.n_digits)
    return ops.is_identity(F2, cuda_pairing.g2_scalar_mul(point, r))


def g2_decompress(comp_bytes: torch.Tensor):
    """(B, 96) uint8 -> (point (X, Y, Z) each (B, 2, 24) Montgomery,
    ok_encoding (B,), ok_curve (B,), ok_subgroup (B,))."""
    point, ok_encoding, ok_curve = g2_decompress_nosub(comp_bytes)
    return point, ok_encoding, ok_curve, g2_subgroup_check(point)
