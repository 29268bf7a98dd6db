"""Distributed NTT: the four-step Cooley-Tukey split N = A B with A = the
world size, and all_to_all between the steps.

`sharded_ntt` takes natural-order input, viewed row-major as the (A, B)
matrix x[n1 B + n2], with the columns split over the ranks:

  step 1: A-point transforms down each column (root w^B)   local
  step 2: G[k1, n2] *= w^(k1 n2)                            local
  step 3: transpose to a row split                          all_to_all
  step 4: B-point transforms along each row (root w^A)      local
  step 5: (natural order) global transpose                  all_to_all

Step 4 leaves X[k1 + A k2] at matrix position [k1, k2], the four-step
order; step 5 undoes that on the devices.

`sharded_ntt_from_brp` takes bit-reversed input (the layout of blobs and
setup tables) split in contiguous blocks: with the column-major split
n = n1 + A n2, M[i1, i2] = x_brp[i1 B + i2] holds x[rev_A(i1) + A rev_B(i2)],
so both local transforms read bit-reversed input as the DIT wants it and
no element is permuted.

An all_to_all_single buffer holds one chunk for each destination rank
along its leading axis, and the received buffer one chunk from each
source rank there; each step below orders the source axis into its place
of the global index before merging it.  Every rank's result is
bit-identical to its block of the single-device ntt.ntt_mont.  N must be
a multiple of the world size squared.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from .. import host
from ..fields import limbs as L
from ..fields.specs import FR
from ..ntt import ntt_mont, root_powers


def _twiddles(b: int, inverse: bool, rows) -> np.ndarray:
    """w^(rows[i] k) for each row index in `rows` and k < b (Montgomery),
    w the (a b)-th root of the setup (a = len(rows)) or its inverse."""
    n = len(rows) * b
    e = np.outer(rows, np.arange(b)) % n
    return root_powers(n)[(n - e) % n if inverse else e]


@functools.cache
def _twiddle_matrix(a: int, b: int, inverse: bool) -> np.ndarray:
    """w^(k1 n2) for k1 < a, n2 < b: step 2 of sharded_ntt."""
    return _twiddles(b, inverse, np.arange(a))


@functools.cache
def _twiddle_matrix_rowbrp(a: int, b: int, inverse: bool) -> np.ndarray:
    """w^(rev_A(i1) k2) for i1 < a, k2 < b: step 2 of sharded_ntt_from_brp,
    whose row index carries the bit-reversed n1."""
    return _twiddles(b, inverse, np.array(host.brp_indices(a)))


def _split(shard_len: int, group) -> tuple[int, int, int]:
    """(world P, rank, B) for a shard of shard_len elements: N = P B, with
    A = P rows of B columns."""
    p, rank = dist.get_world_size(group), dist.get_rank(group)
    if shard_len % p:
        raise ValueError(f"the sharded NTT needs N divisible by the world size squared "
                         f"(N = {shard_len * p}, world {p})")
    return p, rank, shard_len


def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of send's leading axis goes to rank j; chunk j of the result
    came from rank j."""
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv


def input_shard(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's input shard for sharded_ntt from the whole natural-order
    (*batch, N, 16) tensor: the elements n1 B + n2 whose column n2 lies in
    the rank's block, as (*batch, N / world, 16) ordered (n1, n2)."""
    p, rank, b = _split(x.shape[-2] // dist.get_world_size(group), group)
    cols = x.reshape(*x.shape[:-2], p, b, FR.n_digits)[..., rank * (b // p):(rank + 1) * (b // p), :]
    return cols.reshape(*x.shape[:-2], -1, FR.n_digits)


def sharded_ntt(x_shard: torch.Tensor, inverse: bool = False, natural_output: bool = True,
                group=None) -> torch.Tensor:
    """The transform of natural-order Montgomery planes, this rank holding
    the column block of input_shard, (*batch, N / world, 16).

    With natural_output (the default), returns this rank's contiguous
    block of the natural-order result, elements [rank N / world, (rank + 1)
    N / world); else its block of the four-step order, X[k1 + A k2] at
    flat position k1 B + k2."""
    p, rank, b = _split(x_shard.shape[-2], group)
    a = p
    batch = x_shard.shape[:-2]
    bp = b // p
    xm = x_shard.reshape(-1, a, bp, FR.n_digits)  # (F, A, B/P): natural rows, my columns
    f = xm.shape[0]
    tw = torch.as_tensor(_twiddle_matrix(a, b, inverse)[:, rank * bp:(rank + 1) * bp]).to(xm.device)
    g = ntt_mont(xm, inverse=inverse, axis=-3)  # A-point transforms down the columns
    g = L.mont_mul(FR, g, tw)
    # step 3: rows block j to rank j; the columns arrive by source rank
    recv = _all_to_all(g.reshape(f, p, a // p, bp, FR.n_digits).movedim(1, 0), group)
    g = recv.permute(1, 2, 0, 3, 4).reshape(f, a // p, b, FR.n_digits)  # (F, A/P, B)
    out = ntt_mont(g, inverse=inverse, axis=-2)  # B-point transforms along the rows
    if natural_output:
        # step 5: columns k2 block j to rank j; k = k1 + A k2, with k1 by source rank
        recv = _all_to_all(out.reshape(f, a // p, p, bp, FR.n_digits).movedim(2, 0), group)
        out = recv.permute(1, 3, 0, 2, 4).reshape(f, bp, a, FR.n_digits)  # (F, B/P, A)
    return out.reshape(*batch, b, FR.n_digits)


def sharded_ntt_natural(x_shard: torch.Tensor, inverse: bool = False, group=None) -> torch.Tensor:
    """sharded_ntt with natural-order output."""
    return sharded_ntt(x_shard, inverse, natural_output=True, group=group)


def sharded_ntt_from_brp(x_shard: torch.Tensor, inverse: bool = False, group=None) -> torch.Tensor:
    """The transform of bit-reversed Montgomery planes to natural order,
    each rank holding a contiguous block of both: (*batch, N / world, 16)
    in and out.  With inverse, the distributed lagrange_brp_to_monomial."""
    p, rank, b = _split(x_shard.shape[-2], group)
    a = p
    batch = x_shard.shape[:-2]
    bp = b // p
    xm = x_shard.reshape(-1, a // p, b, FR.n_digits)  # (F, A/P, B): my rows rev_A(n1)
    f = xm.shape[0]
    rows = slice(rank * (a // p), (rank + 1) * (a // p))
    tw = torch.as_tensor(_twiddle_matrix_rowbrp(a, b, inverse)[rows]).to(xm.device)
    g = ntt_mont(xm, inverse=inverse, bitrev_input=True, axis=-2)  # B-point along the rows
    g = L.mont_mul(FR, g, tw)
    # step 3: columns block j to rank j; the rows arrive by source rank
    recv = _all_to_all(g.reshape(f, a // p, p, bp, FR.n_digits).movedim(2, 0), group)
    g = recv.movedim(0, 1).reshape(f, a, bp, FR.n_digits)  # (F, A, B/P)
    out = ntt_mont(g, inverse=inverse, bitrev_input=True, axis=-3)  # A-point down the columns
    # step 5: rows k1 block j to rank j; the columns k2 arrive by source rank
    recv = _all_to_all(out.reshape(f, p, a // p, bp, FR.n_digits).movedim(1, 0), group)
    out = recv.permute(1, 2, 0, 3, 4).reshape(f, a // p, b, FR.n_digits)  # k = k1 B + k2
    return out.reshape(*batch, b, FR.n_digits)


@functools.cache
def four_step_order(a: int, b: int) -> np.ndarray:
    """The permutation from the four-step order (X[k1 + a k2] at flat
    position k1 b + k2) to natural order: natural[k] = flat[order[k]]."""
    k = np.arange(a * b)
    return ((k % a) * b + k // a).astype(np.int64)
