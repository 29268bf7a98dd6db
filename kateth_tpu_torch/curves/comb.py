"""Fixed-base comb (Lim-Lee) commitment MSM: the default commit path.

The commitment sum_i s_i P_i multiplies a fixed table of points (the
trusted setup).  Precompute, once per setup,

    T[i][j] = sum_k j_k 2^(k d) P_i      (j in [0, 2^h), bit j_k of j)

so that with the scalar bits in h rows of stride d (bit t + k d):

    sum_i s_i P_i = sum_{t = d-1 .. 0} 2^t sum_i T[i][col_t(i)],
    col_t(i) = sum_k bit_{t + k d}(s_i) << k.

Per column the work is one gather of table rows and a plain sum of N
points.  A commit gathers the rows of all d columns at once, kernel K8
sums chains of g consecutive rows of every column in one launch
(cuda_msm), one halving tree sums each column's chains, and the d column
sums combine MSB first with d - 1 doublings.

The table is affine, as two planes x and y of (N 2^h, 24): at mainnet
(N = 4096, h = 12) 16,777,216 rows, 3.2 GB each as int64 digit planes.
Row j = 0 is the identity, stored as (0, 1) with a clear flag at commit
time.  The build checks that no other entry is the identity (true for
every valid setup: the combination scalar lies in [1, 2^(h d) - 2^d] < r).
"""

from __future__ import annotations

import torch

from ..fields import limbs as L
from ..fields.specs import FP
from ..host import KzgError
from . import cuda_msm, msm, ops

F1 = ops.FP_FIELD
N_BITS = 255
#: setup points per step of the table build: bounds its peak memory (the
#: projective intermediate is 3/2 of the output rows)
BUILD_CHUNK = 512


def comb_dims(h: int) -> int:
    """Columns d for comb width h (h d covers the 255 scalar bits)."""
    return -(-N_BITS // h)


def column_digits(scalar_digits: torch.Tensor, h: int, d: int) -> torch.Tensor:
    """Plain Fr digit planes (..., 16) -> (d, ...) comb column values:
    column t packs bits {t, t + d, ..., t + (h-1) d} into an h-bit index,
    the bits at min(h d, 256) and above read as 0.  Row k of every column
    comes straight from the digit planes (msm.bit_fields), so each step
    works on one (d, ...) tensor and no plane of single bits is built."""
    n_bits = min(h * d, L.DIGIT_BITS * scalar_digits.shape[-1])
    t = torch.arange(d, device=scalar_digits.device)
    cols = msm.bit_fields(scalar_digits, t, 1, n_bits)
    for k in range(1, h):
        bits = msm.bit_fields(scalar_digits, t + k * d, 1, n_bits)
        bits <<= k
        cols |= bits
    return cols


def _tree_inv(spec: L.FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Inversion along axis -2 (a power-of-two length) by a product tree:
    about 3 products an element and one Fermat chain at the root.  Inputs
    must be nonzero."""
    levels = [x]
    cur = x
    while cur.shape[-2] > 1:
        cur = L.mont_mul(spec, cur[..., 0::2, :], cur[..., 1::2, :])
        levels.append(cur)
    inv = L.inv(spec, cur)
    for lev in levels[-2::-1]:
        inv_even = L.mont_mul(spec, inv, lev[..., 1::2, :])
        inv_odd = L.mont_mul(spec, inv, lev[..., 0::2, :])
        inv = torch.stack([inv_even, inv_odd], dim=-2).reshape(lev.shape)
    return inv


def _build_chunk(pts, h: int, d: int):
    """Comb rows of a chunk of C points (projective, (C, 24) each):
    ((C 2^h, 24) x, (C 2^h, 24) y, (C, 2^h) Z-is-zero mask)."""
    C = pts[0].shape[0]
    dev = pts[0].device
    basis = [pts]  # basis[k] = 2^(k d) P
    for _ in range(h - 1):
        p = basis[-1]
        for _ in range(d):
            p = ops.pdouble(F1, p)
        basis.append(p)
    # T[:, j | 2^b] = T[:, j] + basis[b], doubling the table's width each time
    tab = tuple(c.expand(C, 1, FP.n_digits) for c in ops.identity(F1, (), dev))
    for b in range(h):
        new = ops.padd(F1, tab, tuple(c[:, None].expand_as(t) for c, t in zip(basis[b], tab)))
        tab = tuple(torch.cat([t, n], dim=1) for t, n in zip(tab, new))
    X, Y, Z = tab  # (C, 2^h, 24)
    z_zero = L.is_zero(Z)
    one = FP.tensor("one_mont", dev)
    zinv = _tree_inv(FP, torch.where(z_zero[..., None], one, Z))
    x = torch.where(z_zero[..., None], 0, L.mont_mul(FP, X, zinv))
    y = torch.where(z_zero[..., None], one, L.mont_mul(FP, Y, zinv))
    return x.reshape(-1, FP.n_digits), y.reshape(-1, FP.n_digits), z_zero


def build_table(points, h: int):
    """The affine comb rows of the whole setup table, as the pair of planes
    ((N 2^h, 24) x, (N 2^h, 24) y), built BUILD_CHUNK points at a time;
    raises KzgError if an entry other than j = 0 is the identity."""
    d = comb_dims(h)
    N = points[0].shape[0]
    rows = 1 << h
    table_x = torch.empty((N * rows, FP.n_digits), dtype=torch.int64, device=points[0].device)
    table_y = torch.empty_like(table_x)
    for s in range(0, N, BUILD_CHUNK):
        pts = tuple(c[s : s + BUILD_CHUNK] for c in points)
        x, y, z_zero = _build_chunk(pts, h, d)
        if bool(z_zero[:, 1:].any()):
            raise KzgError("comb table entry is the identity (invalid setup)")
        table_x[s * rows : s * rows + x.shape[0]] = x
        table_y[s * rows : s * rows + y.shape[0]] = y
    return table_x, table_y


def commit(table, scalar_digits: torch.Tensor, h: int, n: int):
    """Batched fixed-base commitment sum_i scalars[..., i] P_i.

    table: the (x, y) plane pair of build_table; scalar_digits: PLAIN Fr
    digit planes (*batch, n, 16).  The rows of all d columns are gathered
    at once, K8 sums their chains of cuda_msm.COMB_CHAIN rows (capped at
    n) in one launch, one halving sum per column follows, then the column
    sums combine MSB first.  Returns a projective tuple of (*batch, 24)."""
    table_x, table_y = table
    d = comb_dims(h)
    g = min(cuda_msm.COMB_CHAIN, n)
    batch = scalar_digits.shape[:-2]
    dev = scalar_digits.device
    # contiguous (d, B, n), so that the gathered rows come out in K8's
    # order and its wrapper copies nothing (2.2 GB at 64 mainnet blobs)
    cols = column_digits(scalar_digits, h, d).reshape(d, -1, n)
    idx = cols + (torch.arange(n, device=dev) << h)  # each point's row
    chains = cuda_msm.comb_chain_sum(table_x[idx], table_y[idx], cols != 0, g)  # (d, B, n/g)
    sums = msm.halving_sum(F1, chains, axis=2)  # (d, B)
    acc = ops.identity(F1, (cols.shape[1],), dev)
    for t in range(d - 1, -1, -1):  # MSB column first
        acc = ops.padd(F1, ops.pdouble(F1, acc), tuple(c[t] for c in sums))
    return tuple(c.reshape(*batch, FP.n_digits) for c in acc)
