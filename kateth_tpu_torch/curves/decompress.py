"""Batched G1 decompression (Zcash 48-byte format) on digit planes.

* flag bits in byte 0: 0x80 compressed (must be set), 0x40 infinity,
  0x20 sign (y is the lexicographically larger root);
* infinity requires sign == 0 and every x bit zero;
* x must be canonical (< p);
* y = (x^3 + 4)^((p+1)/4) (p = 3 mod 4), valid iff y^2 == x^3 + 4;
* subgroup membership: r P == identity, by the G1 ladder (kernel K3).

Everything is a mask; the caller raises KzgError from the returned
validity planes.  The square root is one pow-chain kernel (K2) launch.
"""

from __future__ import annotations

import torch

from ..fields import cuda_mont
from ..fields import limbs as L
from ..fields.specs import FP, FR
from . import ops

F1 = ops.FP_FIELD

_SQRT_EXP = (FP.modulus + 1) // 4
#: y is "lexicographically larger" iff y >= (p+1)/2
_HALF_P1 = L.int_to_digits((FP.modulus + 1) // 2, FP.n_digits)
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
    t = L.add(FP, x3, torch.as_tensor(_FOUR_MONT, device=dev).expand_as(x3))
    y = L.pow_const(FP, t, _SQRT_EXP)
    ok_curve = L.eq(L.mont_sqr(FP, y), t) | is_inf

    # the sign flag picks the larger or the smaller root
    y_large = L._geq(L.from_mont(FP, y), torch.as_tensor(_HALF_P1, device=dev))
    y_sel = torch.where((y_large != (s_flag == 1))[..., None], L.neg(FP, y), y)

    batch = flags.shape
    inf_mask = is_inf[..., None]
    point = (
        torch.where(inf_mask, F1.zero(batch, dev), x),
        torch.where(inf_mask, F1.one(batch, dev), y_sel),
        torch.where(inf_mask, F1.zero(batch, dev), F1.one(batch, dev)),
    )
    return point, ok_encoding, ok_curve


def subgroup_check(point) -> torch.Tensor:
    """r P == identity (identity lanes pass trivially)."""
    batch = point[0].shape[:-1]
    r = torch.as_tensor(_R_DIGITS, device=point[0].device).expand(*batch, FR.n_digits)
    return ops.is_identity(F1, cuda_mont.g1_scalar_mul(point, r))


def g1_decompress(comp_bytes: torch.Tensor):
    """(B, 48) uint8 -> (point (X, Y, Z) each (B, 24) Montgomery,
    ok_encoding (B,), ok_curve (B,), ok_subgroup (B,))."""
    point, ok_encoding, ok_curve = g1_decompress_nosub(comp_bytes)
    return point, ok_encoding, ok_curve, subgroup_check(point)
