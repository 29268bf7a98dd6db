"""Batched G1 compression (Zcash 48-byte format) on digit planes.

48 big-endian bytes of the affine x coordinate; in byte 0, bit 7 marks the
compressed form, bit 6 the point at infinity (then every other bit is
zero), bit 5 a y that is the lexicographically larger of {y, p - y}, that
is y > (p - 1)/2.  The inversion of Z is one pow-chain kernel (K2) launch.
"""

from __future__ import annotations

import torch

from ..fields import limbs as L
from ..fields.specs import FP

#: y > (p - 1)/2 iff y >= (p + 1)/2
_HALF_P1 = L.int_to_digits((FP.modulus + 1) // 2, FP.n_digits)


def g1_compress_planes(p) -> torch.Tensor:
    """Projective Montgomery G1 points (tuple of (..., 24)) -> (..., 48)
    uint8 compressed encodings."""
    X, Y, Z = p
    zinv = L.inv(FP, Z)  # 0 for the identity (0^(p-2) = 0)
    x = L.from_mont(FP, L.mont_mul(FP, X, zinv))
    y = L.from_mont(FP, L.mont_mul(FP, Y, zinv))
    inf = L.is_zero(Z)
    larger = L._geq(y, torch.as_tensor(_HALF_P1, device=y.device)) & ~inf
    xb = torch.where(inf[..., None], 0, L.digits_to_be_bytes(FP, x))
    flags = 0x80 | (inf.to(torch.uint8) << 6) | (larger.to(torch.uint8) << 5)
    xb[..., 0] |= flags
    return xb


def points_to_bytes(pt) -> list[bytes]:
    """Batched projective Montgomery points -> list of 48-byte encodings."""
    raw = g1_compress_planes(pt).reshape(-1, 48).cpu().numpy()
    return [raw[i].tobytes() for i in range(raw.shape[0])]
