"""Point sums: the inclusive prefix scan, the sum of points along an axis,
and the windowed Pippenger MSM of the commit path.

The MSM keeps the bucket algebra of Pippenger without any scatter: per
c-bit window the points are sorted by digit (a stable argsort), one
inclusive prefix scan along the sorted axis (the two-level scan of
cuda_msm, kernel K7) gives every bucket-boundary partial sum, and the
weighted bucket sum telescopes into (2^c - 1) total - sum of the 2^c - 1
boundary prefixes.  Windows combine MSB first with c doublings between.

Sums of points halve pairwise (n - 1 additions); the JAX package's
Hillis-Steele tree_sum does log2(n) times as many.
"""

from __future__ import annotations

import torch

from ..fields import limbs as L
from . import ops
from .ops import CurveField

#: the scalar bits the windows cover (Fr elements are below 2^255)
N_BITS = 255


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


def _pad_pot(F: CurveField, p, ax: int):
    """Pad the point axis `ax` with identities to a power of two."""
    n = p[0].shape[ax]
    pot = 1 if n <= 1 else 1 << (n - 1).bit_length()
    if pot == n:
        return p
    ident = ops.identity(F, (), p[0].device)
    padded = []
    for i, a in zip(ident, p):
        pad_shape = list(a.shape)
        pad_shape[ax] = pot - n
        padded.append(torch.cat([a, i.expand(pad_shape)], dim=ax))
    return tuple(padded)


def halving_sum(F: CurveField, p, axis: int):
    """Sum of points along `axis` by pairwise halving (n - 1 additions in
    log2(n) rounds), the length padded with identities to a power of two."""
    ax = axis % p[0].ndim
    p = _pad_pot(F, p, ax)
    n = p[0].shape[ax]
    while n > 1:
        n //= 2
        p = ops.padd(F, tuple(c.narrow(ax, 0, n) for c in p), tuple(c.narrow(ax, n, n) for c in p))
    return tuple(c.squeeze(ax) for c in p)


def scalar_mul_const(F: CurveField, p, k: int):
    """p k for a static k >= 0 by MSB-first double-and-add."""
    if k == 0:
        return ops.identity(F, p[0].shape[: p[0].ndim - F.fdim], p[0].device)
    acc = p
    for bit in bin(k)[3:]:
        acc = ops.pdouble(F, acc)
        if bit == "1":
            acc = ops.padd(F, acc, p)
    return acc


def bit_fields(scalar_digits: torch.Tensor, starts: torch.Tensor, width: int, n_bits: int) -> torch.Tensor:
    """Plain Fr digit planes (..., 16) -> (F, ...) bit fields: field f holds
    the `width` bits (width <= 16) of each scalar from bit starts[f] on,
    LSB first, the bits at n_bits (<= 256) and above read as 0; starts:
    (F,) int64 bit offsets on the digits' device.

    A field spans at most two 16-bit digits k and k + 1 (k = start // 16),
    so it is ((d[k] >> s) | (d[k + 1] << (16 - s))) & mask, s = start % 16,
    read straight from the digit planes: every intermediate has the
    output's shape, and no plane of single bits is built."""
    if not 1 <= width <= L.DIGIT_BITS:
        raise ValueError(f"bit field width {width} is not in 1 .. {L.DIGIT_BITS}")
    view = (-1,) + (1,) * (scalar_digits.ndim - 1)
    top = scalar_digits.shape[-1] - 1
    shift = (starts % L.DIGIT_BITS).view(view)
    mask = ((1 << (n_bits - starts).clamp(0, width)) - 1).view(view)
    # bits past the last digit lie at or above n_bits, so the digit
    # indices stop at the last digit
    k = (starts // L.DIGIT_BITS).clamp(max=top)
    planes = scalar_digits.movedim(-1, 0)  # (16, ...), a view
    out = planes.index_select(0, k)  # (F, ...)
    out >>= shift
    if width > 1:  # a single bit never reaches the next digit
        hi = planes.index_select(0, (k + 1).clamp(max=top))
        hi <<= L.DIGIT_BITS - shift
        out |= hi
    out &= mask
    return out


def window_digits(scalar_digits: torch.Tensor, c: int, n_bits: int = N_BITS) -> torch.Tensor:
    """Plain Fr digit planes (..., 16) -> (W, ...) c-bit window values
    (least significant window first), W = ceil(n_bits / c), c <= 16."""
    W = -(-n_bits // c)
    return bit_fields(scalar_digits, torch.arange(W, device=scalar_digits.device) * c, c, n_bits)


def _window_sum(points, dig: torch.Tensor, c: int):
    """Bucket sum of one window over G1: sum_i dig[..., i] points[i].

    dig: (*batch, N) window digits; points: projective tuple of (N, 24),
    shared by the batch.  Returns a projective tuple of (*batch, 24)."""
    from . import cuda_msm

    F = ops.FP_FIELD
    B = 1 << c
    batch = dig.shape[:-1]
    order = torch.argsort(dig, dim=-1, stable=True)
    sorted_digits = torch.take_along_dim(dig, order, dim=-1)

    # c_j = #digits < j for j = 1 .. B-1; the boundary prefix is the one
    # just before bucket j starts, the identity when no digit is below j
    j = torch.arange(1, B, device=dig.device).expand(*batch, B - 1).contiguous()
    c_j = torch.searchsorted(sorted_digits.contiguous(), j)
    idx = (c_j - 1).clamp(min=0)
    last = torch.full_like(idx[..., :1], dig.shape[-1] - 1)
    # the prefix sums of the sorted points at the B - 1 boundaries and at
    # the last point (the total), from a scan whose offset add runs on
    # these B lanes a row alone; the gathered points go in unnamed, so
    # that the scan frees them once K7 has read them
    sums = cuda_msm.prefix_scan_kernel(tuple(comp[order] for comp in points),
                                       torch.cat([idx, last], dim=-1))
    total = tuple(a[..., -1, :] for a in sums)
    boundary = tuple(a[..., :-1, :] for a in sums)
    boundary = ops.pselect(F, c_j == 0, ops.identity(F, (*batch, B - 1), dig.device), boundary)

    # window sum = (B - 1) total - sum_j boundary_j (telescoping)
    gsum = halving_sum(F, boundary, axis=-2)
    return ops.padd(F, scalar_mul_const(F, total, B - 1), ops.pneg(F, gsum))


def pad_points(points):
    """The setup points padded with identities to a power of two, the
    length every window of msm sorts and scans (the same tuple when it is
    one already)."""
    return _pad_pot(ops.FP_FIELD, points, 0)


def window_start(scalar_digits: torch.Tensor, n_points: int, c: int):
    """The carry and the inputs of msm's window loop: the identity
    accumulator, a projective tuple of (*batch, 24), and the window digits
    of the PLAIN Fr digits (*batch, N, 16), most significant window first,
    (W, *batch, n_points), zero for the n_points - N padding points."""
    n = scalar_digits.shape[-2]
    if n_points > n:  # zero scalars for the padding points
        scalar_digits = torch.nn.functional.pad(scalar_digits, (0, 0, 0, n_points - n))
    W = -(-N_BITS // c)
    starts = torch.arange(W - 1, -1, -1, device=scalar_digits.device) * c  # MSB window first
    digits = bit_fields(scalar_digits, starts, c, N_BITS)
    return ops.identity(ops.FP_FIELD, scalar_digits.shape[:-2], digits.device), digits


def window_step(points, acc, dig: torch.Tensor, c: int):
    """One window of msm, the step of its loop: c doublings of the
    accumulator acc, then the window's bucket sum added.  points: the
    padded setup points (pad_points); dig: the window's digits
    (*batch, n_points)."""
    F = ops.FP_FIELD
    for _ in range(c):
        acc = ops.pdouble(F, acc)
    return ops.padd(F, acc, _window_sum(points, dig, c))


def msm(points, scalar_digits: torch.Tensor, c: int = 8):
    """sum_i scalars[..., i] points[i] over G1, batched over the leading
    scalar dims.

    points: projective tuple of (N, 24), shared by the batch (the setup
    table); scalar_digits: PLAIN Fr digits (*batch, N, 16).  Returns a
    projective tuple of (*batch, 24).  One window at a time, MSB first: the
    loop of the JAX package's lax.scan, whose carry and inputs
    window_start gives and whose step is window_step."""
    points = pad_points(points)  # identity points with zero digits
    acc, digits = window_start(scalar_digits, points[0].shape[0], c)
    for dig in digits:
        acc = window_step(points, acc, dig, c)
    return acc
