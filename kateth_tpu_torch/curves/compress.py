"""Batched G1 and G2 compression (Zcash 48- and 96-byte formats) on digit
planes.

G1: 48 big-endian bytes of the affine x coordinate; in byte 0, bit 7 marks
the compressed form, bit 6 the point at infinity (then every other bit is
zero), bit 5 a y that is the lexicographically larger of {y, p - y}, that
is y > (p - 1)/2.  The inversion of Z is one pow-chain kernel (K2) launch.

G2: 96 bytes, x.c1 || x.c0, each 48 big-endian bytes, the flags in byte 0;
y is the larger of {y, -y} when y.c1 > (p - 1)/2, or y.c1 = 0 and
y.c0 > (p - 1)/2.  The inversion of Z (fields/fp2.py) is one K2 launch on
its norm.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import fp2
from ..fields import limbs as L
from ..fields.specs import FP

#: a > (p - 1)/2 iff a >= (p + 1)/2, made once per device
_HALF_P1 = L.DeviceConstants(lambda _: L.int_to_digits((FP.modulus + 1) // 2, FP.n_digits))


def gt_half(a: torch.Tensor) -> torch.Tensor:
    """a > (p - 1)/2 for plain canonical digit planes (..., 24)."""
    return L._geq(a, _HALF_P1.get(None, a.device))


def fp2_is_larger(y: torch.Tensor) -> torch.Tensor:
    """y > -y lexicographically on plain Fp2 planes (..., 2, 24): the c1
    component decides, c0 when c1 is zero."""
    c0, c1 = y[..., 0, :], y[..., 1, :]
    return gt_half(c1) | (L.is_zero(c1) & gt_half(c0))


def _with_flags(xb: torch.Tensor, inf: torch.Tensor, larger: torch.Tensor) -> torch.Tensor:
    """Zero the encodings of the identity, then set the three flag bits."""
    xb = torch.where(inf[..., None], 0, xb)
    xb[..., 0] |= 0x80 | (inf.to(torch.uint8) << 6) | ((larger & ~inf).to(torch.uint8) << 5)
    return xb


def g1_compress_planes(p) -> torch.Tensor:
    """Projective Montgomery G1 points (tuple of (..., 24)) -> (..., 48)
    uint8 compressed encodings."""
    X, Y, Z = p
    zinv = L.inv(FP, Z)  # 0 for the identity (0^(p-2) = 0)
    x = L.from_mont(FP, L.mont_mul(FP, X, zinv))
    y = L.from_mont(FP, L.mont_mul(FP, Y, zinv))
    return _with_flags(L.digits_to_be_bytes(FP, x), L.is_zero(Z), gt_half(y))


def rows_to_bytes(raw: np.ndarray) -> list[bytes]:
    """A read-back (B, W) uint8 array of encodings -> list of W-byte
    strings."""
    return [row.tobytes() for row in raw]


def points_to_bytes(pt) -> list[bytes]:
    """Batched projective Montgomery points -> list of 48-byte encodings."""
    return rows_to_bytes(g1_compress_planes(pt).reshape(-1, 48).cpu().numpy())


def g2_compress_planes(p) -> torch.Tensor:
    """Projective Montgomery G2 points (tuple of (..., 2, 24)) -> (..., 96)
    uint8 compressed encodings."""
    X, Y, Z = p
    zinv = fp2.inv(Z)  # 0 for the identity
    x = L.from_mont(FP, fp2.mul(X, zinv))
    y = L.from_mont(FP, fp2.mul(Y, zinv))
    xb = torch.cat([L.digits_to_be_bytes(FP, x[..., 1, :]), L.digits_to_be_bytes(FP, x[..., 0, :])], -1)
    return _with_flags(xb, fp2.is_zero(Z), fp2_is_larger(y))


def g2_points_to_bytes(pt) -> list[bytes]:
    """Batched projective Montgomery G2 points -> list of 96-byte encodings."""
    return rows_to_bytes(g2_compress_planes(pt).reshape(-1, 96).cpu().numpy())
