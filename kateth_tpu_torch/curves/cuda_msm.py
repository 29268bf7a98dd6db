"""Wrappers for the commitment kernels K7 and K8, each beside its plain
version.

  K7 prefix_scan     -> kateth_tpu/curves/pallas_msm.py::_chunked_prefix_flat
  K8 comb_chain_sum  -> kateth_tpu/curves/pallas_msm.py::_comb_chain_sum_flat

Both kernels (csrc/msm.cu) give a team of 8 threads one chain of g
consecutive point rows of the digit plane layout (rows, 24) and add the
chain's points in order with the complete formulas, so the plain versions,
loops of ops.padd in the same order, give the same projective digits.
Both stage their rows with 16-byte copies, so the wrappers hand them
16-byte aligned rows.  On a CPU tensor a wrapper runs the plain version
instead.
"""

from __future__ import annotations

import torch

from .. import cuda_lib
from ..fields.specs import FP
from . import msm, ops

F1 = ops.FP_FIELD

#: points per chain of the windowed MSM's bucket scan
CHAIN = 8
#: comb rows per chain of the fixed-base commit
COMB_CHAIN = 32
#: the slices of the leading rows (blobs) that the chain totals' scan of
#: prefix_scan_kernel runs over (its docstring says why)
ROW_SLICES = CHAIN // 2


def _chains(c: torch.Tensor, g: int) -> torch.Tensor:
    """(..., N, 24) -> (..., N/g, g, 24)."""
    if c.shape[-2] % g:
        raise ValueError(f"the point axis ({c.shape[-2]}) is not a multiple of g = {g}")
    return c.reshape(*c.shape[:-2], c.shape[-2] // g, g, FP.n_digits)


def row_slices(rows: int) -> list[slice]:
    """`rows` leading rows cut into ROW_SLICES slices of equal size (the
    last one shorter; one row a slice below ROW_SLICES rows)."""
    step = max(1, -(-rows // ROW_SLICES))
    return [slice(r, r + step) for r in range(0, rows, step)]


def _aligned16(c: torch.Tensor) -> torch.Tensor:
    """c contiguous at a 16-byte boundary (a fresh copy if it is not)."""
    c = c.contiguous()
    return c if c.data_ptr() % 16 == 0 else c.clone()


# --- K7 ---------------------------------------------------------------------

def chain_prefix_plain(p, g: int):
    """Inclusive prefix sums within each chain of g consecutive points along
    axis -2: acc = identity, acc += p_k, out_k = acc."""
    chains = tuple(_chains(c, g) for c in p)
    acc = ops.identity(F1, chains[0].shape[:-2], chains[0].device)
    outs = []
    for k in range(g):
        acc = ops.padd(F1, acc, tuple(c[..., k, :] for c in chains))
        outs.append(acc)
    return tuple(torch.stack([o[i] for o in outs], dim=-2).reshape(p[i].shape) for i in range(3))


def chain_prefix(p, g: int):
    """Within-chain inclusive prefix sums (kernel K7 on a CUDA tensor):
    p is a projective tuple of (..., N, 24) Montgomery coordinates."""
    if p[0].device.type == "cpu":
        return chain_prefix_plain(p, g)
    pts = [_aligned16(c) for c in p]
    chains = _chains(pts[0], g).shape[:-2].numel()
    outs = [torch.empty_like(c) for c in pts]
    dev = cuda_lib.check_cuda(*pts, *outs)
    if chains:
        cuda_lib.launch(
            "prefix_scan", dev, *(t.data_ptr() for t in pts),
            *(t.data_ptr() for t in outs), chains, g,
        )
    return tuple(outs)


def prefix_scan_kernel(p, idx: torch.Tensor):
    """Inclusive prefix sums of G1 points along axis -2 at the indices idx
    by the two-level scan: K7's sequential sums within chains of CHAIN
    points, a short Hillis-Steele exclusive scan of the chain totals, and
    the offset add of each index's chain offset.  p: projective tuple of
    (..., N, 24), N a power of two; idx: int64 (..., M) indices into the
    point axis.  Returns the sums at those indices, (..., M, 24).

    A complete addition holds about 100 Fp planes of temporaries a lane
    (17 KB), against the 3 planes a lane of the points and of K7's output.
    So the offset add runs on the M gathered lanes only (the windowed MSM
    reads 2^c sums of each row's N: over all N lanes the addition held 4.4
    GB at 64 mainnet blobs), and the chain totals' scan, on N / CHAIN
    lanes a row, runs over ROW_SLICES = CHAIN // 2 slices of the rows,
    each then holding about 100 / (CHAIN^2 / 2) = 3 planes of N lanes a
    row, K7's output's size; more slices only add graph nodes.  Every sum is the
    unsliced full scan's, lane for lane.  The points are released once K7
    has read them, so pass them in without keeping them."""
    dev = p[0].device
    g = min(CHAIN, p[0].shape[-2])
    within = chain_prefix(p, g)  # (..., N, 24)
    del p
    totals = tuple(_chains(w, g)[..., g - 1, :] for w in within)  # (..., G, 24)
    rows = totals[0].shape[:-2].numel()
    flat = tuple(t.reshape(rows, *t.shape[-2:]) for t in totals)
    parts = [msm.prefix_scan(F1, tuple(t[s] for t in flat), axis=-2) for s in row_slices(rows)]
    incl = tuple(torch.cat([q[i] for q in parts]).reshape(totals[i].shape) for i in range(3))
    ident = ops.identity(F1, (), dev)
    excl = tuple(
        torch.cat([i.expand(*t.shape[:-2], 1, FP.n_digits), t[..., :-1, :]], dim=-2)
        for i, t in zip(ident, incl)
    )
    lane = idx[..., None]
    chain = lane // g
    return ops.padd(F1, tuple(torch.take_along_dim(w, lane, dim=-2) for w in within),
                    tuple(torch.take_along_dim(e, chain, dim=-2) for e in excl))


# --- K8 ---------------------------------------------------------------------

def comb_chain_sum_plain(x: torch.Tensor, y: torch.Tensor, flags: torch.Tensor, g: int):
    """Sum of each chain of g consecutive affine rows, a row whose flag is
    clear being the identity: ops.padd with Z2 = flag ? 1 : 0."""
    one = FP.tensor("one_mont", x.device)
    z = torch.where(flags[..., None].bool(), one, 0)
    rows = tuple(_chains(c, g) for c in (x, y, z))
    acc = ops.identity(F1, rows[0].shape[:-2], x.device)
    for k in range(g):
        acc = ops.padd(F1, acc, tuple(c[..., k, :] for c in rows))
    return acc


def comb_chain_sum(x: torch.Tensor, y: torch.Tensor, flags: torch.Tensor, g: int = COMB_CHAIN):
    """Chain sums of gathered comb rows (kernel K8 on a CUDA tensor).

    x, y: (..., N, 24) affine Montgomery rows; flags: (..., N), nonzero for
    a point.  Returns a projective tuple of (..., N/g, 24) chain totals.
    comb.commit calls it once for all comb columns: (d, B, N, 24)."""
    if y.shape != x.shape or flags.shape != x.shape[:-1]:
        raise ValueError("comb_chain_sum takes x, y (..., N, 24) and flags (..., N)")
    if x.device.type == "cpu":
        return comb_chain_sum_plain(x, y, flags, g)
    x, y = _aligned16(x), _aligned16(y)
    fl = flags.to(torch.int64).contiguous()
    shape = _chains(x, g).shape[:-2]
    outs = [torch.empty((*shape, FP.n_digits), dtype=torch.int64, device=x.device) for _ in range(3)]
    dev = cuda_lib.check_cuda(x, y, fl, *outs)
    chains = shape.numel()
    if chains:
        cuda_lib.launch(
            "comb_chain_sum", dev, x.data_ptr(), y.data_ptr(), fl.data_ptr(),
            *(t.data_ptr() for t in outs), chains, g,
        )
    return tuple(outs)
