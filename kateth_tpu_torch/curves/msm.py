"""The point sums of the verify path: an inclusive prefix scan of points
and the sum of a batch of points (the windowed MSM is not ported yet)."""

from __future__ import annotations

import torch

from . import ops
from .ops import CurveField


def prefix_scan(F: CurveField, p, axis: int = 0):
    """Inclusive prefix sum of points along `axis` (Hillis-Steele: log2(n)
    rounds of one complete addition each; n a power of two).  Identity
    points slide in from below at each shift."""
    n = p[0].shape[axis]
    if n & (n - 1):
        raise ValueError("prefix_scan requires a power-of-two length")
    ax = axis % p[0].ndim
    shift = 1
    while shift < n:
        ident = ops.identity(F, (), p[0].device)
        shifted = []
        for i, a in zip(ident, p):
            pad_shape = list(a.shape)
            pad_shape[ax] = shift
            shifted.append(torch.cat([i.expand(pad_shape), a.narrow(ax, 0, n - shift)], dim=ax))
        p = ops.padd(F, p, tuple(shifted))
        shift *= 2
    return p


def tree_sum(F: CurveField, p, axis: int = 0):
    """Sum points along `axis`: pad with identities to a power of two,
    prefix-scan, take the last."""
    n = p[0].shape[axis]
    pot = 1 if n <= 1 else 1 << (n - 1).bit_length()
    ax = axis % p[0].ndim
    if pot != n:
        ident = ops.identity(F, (), p[0].device)
        padded = []
        for i, a in zip(ident, p):
            pad_shape = list(a.shape)
            pad_shape[ax] = pot - n
            padded.append(torch.cat([a, i.expand(pad_shape)], dim=ax))
        p = tuple(padded)
    return tuple(a.select(ax, pot - 1) for a in prefix_scan(F, p, axis=ax))
