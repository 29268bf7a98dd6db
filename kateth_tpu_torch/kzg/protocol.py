"""The device half of the KZG operations.

* decode_blobs            -- per-element canonicality of the blobs
* evaluate                -- barycentric evaluation with no field inversion
* quotient                -- the quotient polynomial, with the root-hit row
* commit_comb, commit_msm -- the commitment MSM: fixed-base comb (kernel
                             K8) or windowed Pippenger (kernel K7)
* verify_kzg_bytes        -- single-point verification up to the pairing
                             check (kernels K3 and K6)
* verify_blob_batch_fused -- decode, G1 decompression, evaluation and one
                             G1 ladder carrying the random-linear-combination
                             lincombs and the subgroup checks
* pairing_check           -- e(a1, a2) == e(b1, [1]_2)
* verify_blob_batch       -- the two above: a batch's verdict and masks
* verify_kzg              -- verify_kzg_bytes, then pairing_check: one
                             opening's verdict and masks
* validate_g1             -- full G1 decompression masks (kernel K3's
                             subgroup check included)
* commit_chunk            -- decode, commit and compress a chunk of blobs
* prove_chunk             -- decode, evaluate, quotient, commit and compress:
                             a chunk of blobs' proofs at their points
* commit_scan, prove_scan -- commit_chunk and prove_chunk with the windowed
                             commit, as a Scan: a head, one window step
                             looped over the windows, and a tail
* to_device, fr_planes    -- host arrays to the device in one asynchronous
                             copy

Special cases are masks, not control flow, and nothing here reads a tensor
back to the host or uploads a constant more than once per device.  The five
programs verify_blob_batch, verify_kzg, validate_g1, commit_chunk and
prove_chunk take and return tensors only: graphs.py captures each of them
as a CUDA graph, and the CPU runs them eagerly.  A Scan's head, step and
tail do too: graphs.py captures each as a graph of its own and replays the
step once a window, as the JAX package runs its lax.scan.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..curves import comb, compress, cuda_msm, decompress, ops
from ..curves import g1 as g1mod
from ..curves import g2 as g2mod
from ..curves import msm
from ..fields import cuda_mont
from ..fields import limbs as L
from ..fields.specs import FR
from .. import cuda_pairing, host, pairing

F1 = ops.FP_FIELD
F2 = ops.FP2_FIELD


#: N^-1 mod r in Montgomery form, keyed by N, made once per device
_N_INV = L.DeviceConstants(lambda n: FR.from_int(pow(n, host.R - 2, host.R)))


def decode_blobs(blob_bytes: torch.Tensor):
    """(B, 32 N) uint8 -> (elements_plain (B, N, 16), ok (B,)): ok[b] iff
    every 32-byte chunk of blob b is a canonical big-endian Fr."""
    B = blob_bytes.shape[0]
    digits = L.be_bytes_to_digits(FR, blob_bytes.reshape(B, -1, 32))
    return digits, L.lt_modulus(FR, digits).all(-1)


def evaluate(elements_mont: torch.Tensor, z_mont: torch.Tensor, roots: torch.Tensor):
    """y = p(z) by the barycentric formula over the BRP'd roots w_i.

    Since prod_i (z - w_i) = z^N - 1, the formula's closing factor cancels:
    y = N^-1 sum_i f_i w_i prefix_{i-1} suffix_{i+1} with prefix and suffix
    products of (z - w_i).  A z equal to a root takes that element.

    elements_mont (B, N, 16), z_mont (B, 16), roots (N, 16) Montgomery;
    returns y_mont (B, 16)."""
    n = roots.shape[0]
    hit = L.eq(z_mont[:, None, :], roots[None, :, :])  # (B, N)
    any_hit = hit.any(-1)
    y_hit = L.sum_mod(FR, torch.where(hit[..., None], elements_mont, 0), axis=-2)
    d = L.sub(FR, z_mont[:, None, :], roots.expand_as(elements_mont))
    # a root hit has one zero factor: mask it to one (the lane takes y_hit)
    one = FR.tensor("one_mont", d.device)
    safe = torch.where(hit[..., None], one, d)
    prefix = L.scan_mul(FR, safe)
    suffix = L.scan_mul(FR, safe, reverse=True)
    ones = one.expand(safe.shape[0], 1, FR.n_digits)
    prefix_shift = torch.cat([ones, prefix[:, : n - 1]], dim=1)
    suffix_shift = torch.cat([suffix[:, 1:], ones], dim=1)
    fw = L.mont_mul(FR, elements_mont, roots.expand_as(elements_mont))
    terms = L.mont_mul(FR, L.mont_mul(FR, fw, prefix_shift), suffix_shift)
    s = L.sum_mod(FR, terms, axis=-2)
    y = L.mont_mul(FR, s, _N_INV.get(n, s.device).expand_as(s))
    return torch.where(any_hit[..., None], y_hit, y)


def quotient(elements_mont, z_mont, y_mont, roots, inv_roots):
    """q_i = (f_i - y) / (w_i - z), and where z is the root w_h the special
    row q_h = -(sum_j (f_j - y) w_j / (w_j - z)) / w_h (the hit term's
    inverse is zero).  All Montgomery: elements (B, N, 16), z and y (B, 16),
    roots and inv_roots (N, 16); returns q (B, N, 16)."""
    rootsb = roots.expand_as(elements_mont)
    hit = L.eq(z_mont[:, None, :], roots[None, :, :])  # (B, N)
    invs = L.batch_inv(FR, L.sub(FR, rootsb, z_mont[:, None, :]))  # hit -> 0
    fy = L.sub(FR, elements_mont, y_mont[:, None, :])
    q = L.mont_mul(FR, fy, invs)
    t = L.mont_mul(FR, L.mont_mul(FR, fy, rootsb), invs)
    s = L.neg(FR, L.sum_mod(FR, t, axis=-2))  # (B, 16)
    inv_hit = L.sum_mod(FR, torch.where(hit[..., None], inv_roots.expand_as(elements_mont), 0))
    q_hit = L.mont_mul(FR, s, inv_hit)
    return torch.where(hit[..., None], q_hit[:, None, :], q)


def commit_comb(table, scalars_plain, h: int, n: int):
    """Fixed-base comb commitment of (B, N, 16) plain scalars against the
    comb table (curves/comb.py) -> projective G1 points, (B, 24) each."""
    return comb.commit(table, scalars_plain, h, n)


def commit_msm(g1_points, scalars_plain, window: int = 8):
    """Windowed Pippenger commitment of (B, N, 16) plain scalars against
    the (N,)-point setup table -> projective G1 points, (B, 24) each."""
    return msm.msm(g1_points, scalars_plain, c=window)


def pairing_check(a1, a2, b1):
    """e(a1, a2) == e(b1, [1]_2) per leading index of the points."""
    B = a1[0].shape[0]
    g2gen = tuple(g.expand(B, *g.shape) for g in g2mod.generator(a1[0].device))
    return pairing.verify_pairings((a1, a2), (b1, g2gen))


def verify_blob_batch_fused(
    blob_bytes, comm_bytes, proof_bytes, z_plain, zw_plain, w_plain, roots, tau2
):
    """Batch verification up to the pairing check.

    Decodes and validates the blobs, decompresses commitments and proofs
    (one pass over both), lifts to Montgomery form, evaluates each blob at
    its challenge, and runs ONE G1 ladder (kernel K3) over the lanes
    [proof w | comm w | proof z w | (-G) sum(w y) | r comm | r proof]; the
    last 2B lanes are the subgroup checks.  sum w (C - y G) becomes
    sum w C - (sum w y) G, so the y G terms cost one lane.

    Returns ((lhs, tau2, rhs) for pairing_check, packed) where packed is a
    (7, B) bool plane: [ok_blob, comm encoding / curve / subgroup, proof
    encoding / curve / subgroup]."""
    B = blob_bytes.shape[0]
    dev = blob_bytes.device
    elements, ok_blob = decode_blobs(blob_bytes)
    pts, enc_ok, curve_ok = decompress.g1_decompress_nosub(torch.cat([comm_bytes, proof_bytes]))
    comm_pt = tuple(a[:B] for a in pts)
    proof_pt = tuple(a[B:] for a in pts)
    elements_mont = L.to_mont(FR, elements)
    z_mont = L.to_mont(FR, z_plain)
    y_mont = evaluate(elements_mont, z_mont, roots)
    wy = L.mont_mul(FR, L.to_mont(FR, w_plain), y_mont)  # (B, 16)
    pot = 1 if B <= 1 else 1 << (B - 1).bit_length()
    wy = torch.cat([wy, wy.new_zeros(pot - B, FR.n_digits)])
    s_plain = L.from_mont(FR, L.sum_mod(FR, wy, axis=-2))  # (16,)
    neg_g1 = ops.pneg(F1, tuple(g[None] for g in g1mod.generator(dev)))
    lanes = tuple(
        torch.cat([p, c, p, g, c, p]) for p, c, g in zip(proof_pt, comm_pt, neg_g1)
    )
    r = decompress.group_order(dev).expand(2 * B, FR.n_digits)
    sc = torch.cat([w_plain, w_plain, zw_plain, s_plain[None], r])
    prods = cuda_mont.g1_scalar_mul(lanes, sc)
    lin = tuple(a[: 3 * B].reshape(3, B, *a.shape[1:]) for a in prods)
    sums = msm.halving_sum(F1, lin, axis=1)
    lhs1 = tuple(a[0] for a in sums)
    sG = tuple(a[3 * B] for a in prods)
    lhs2 = ops.padd(F1, tuple(a[1] for a in sums), sG)
    sub_ok = ops.is_identity(F1, tuple(a[3 * B + 1 :] for a in prods))  # [comm | proof]
    rhs = ops.padd(F1, lhs2, tuple(a[2] for a in sums))
    packed = torch.stack(
        [ok_blob, enc_ok[:B], curve_ok[:B], sub_ok[:B], enc_ok[B:], curve_ok[B:], sub_ok[B:]]
    )
    pc_in = (
        tuple(c[None] for c in lhs1),
        tuple(c[None] for c in tau2),
        tuple(c[None] for c in rhs),
    )
    return pc_in, packed


def verify_kzg_bytes(proof_bytes, comm_bytes, z_plain, y_plain, tau2):
    """Single-point verification up to the pairing check.

    Decompresses proofs and commitments in one pass, runs ONE G1 ladder
    (kernel K3) over [(-G1) y | r proof | r comm] (the subgroup checks ride
    along), and the G2 ladder (kernel K6) for z (-G2).  Returns (a1, a2, b1)
    for pairing_check: a1 = proof, a2 = [tau]_2 - z G2, b1 = C - y G1; then
    the proof masks and the commitment masks, each (ok_encoding, ok_curve,
    ok_subgroup)."""
    B = z_plain.shape[0]
    dev = z_plain.device
    pts, enc_ok, curve_ok = decompress.g1_decompress_nosub(torch.cat([proof_bytes, comm_bytes]))
    proof_pt = tuple(a[:B] for a in pts)
    comm_pt = tuple(a[B:] for a in pts)
    neg_g1 = ops.pneg(F1, tuple(g.expand(B, -1) for g in g1mod.generator(dev)))
    lanes = tuple(torch.cat([g, a]) for g, a in zip(neg_g1, pts))
    sc = torch.cat([y_plain, decompress.group_order(dev).expand(2 * B, FR.n_digits)])
    prods = cuda_mont.g1_scalar_mul(lanes, sc)
    sub_ok = ops.is_identity(F1, tuple(a[B:] for a in prods))  # [proof | comm]
    b1 = ops.padd(F1, comm_pt, tuple(a[:B] for a in prods))
    neg_g2 = ops.pneg(F2, tuple(g.expand(B, 2, -1) for g in g2mod.generator(dev)))
    a2 = ops.padd(F2, tuple(t.expand(B, 2, -1) for t in tau2), cuda_pairing.g2_scalar_mul(neg_g2, z_plain))
    return (
        proof_pt,
        a2,
        b1,
        (enc_ok[:B], curve_ok[:B], sub_ok[:B]),
        (enc_ok[B:], curve_ok[B:], sub_ok[B:]),
    )


def fr_to_mont(x_plain: torch.Tensor) -> torch.Tensor:
    return L.to_mont(FR, x_plain)


def fr_from_mont(x_mont: torch.Tensor) -> torch.Tensor:
    return L.from_mont(FR, x_mont)


def verify_blob_batch(blob_bytes, comm_bytes, proof_bytes, z_plain, zw_plain, w_plain, roots, tau2):
    """verify_blob_batch_fused, then pairing_check: (verdict, a 0-d bool
    tensor, and the (7, B) packed masks).  graphs.py captures it as one
    CUDA graph."""
    pc_in, packed = verify_blob_batch_fused(
        blob_bytes, comm_bytes, proof_bytes, z_plain, zw_plain, w_plain, roots, tau2)
    return pairing_check(*pc_in)[0], packed


def verify_kzg(proof_bytes, comm_bytes, z_plain, y_plain, tau2):
    """verify_kzg_bytes, then pairing_check: (verdict (B,) bool, and the
    (6, B) packed masks: proof encoding, curve and subgroup, then the same
    for the commitment)."""
    a1, a2, b1, proof_masks, comm_masks = verify_kzg_bytes(
        proof_bytes, comm_bytes, z_plain, y_plain, tau2)
    return pairing_check(a1, a2, b1), torch.stack([*proof_masks, *comm_masks])


def validate_g1(point_bytes):
    """(B, 48) uint8 -> ((3, B) bool masks: encoding, curve, subgroup,)."""
    _, ok_enc, ok_curve, ok_sub = decompress.g1_decompress(point_bytes)
    return (torch.stack([ok_enc, ok_curve, ok_sub]),)


def commit_chunk(blob_bytes, commit):
    """decode_blobs, commit, then G1 compression: (ok (B,), (B, 48) uint8
    commitments).  `commit` maps (B, N, 16) plain scalars to projective
    points: commit_comb or commit_msm with its table bound."""
    elements, ok = decode_blobs(blob_bytes)
    return ok, compress.g1_compress_planes(commit(elements))


def quotient_chunk(blob_bytes, z_plain, roots, inv_roots):
    """prove_chunk up to the commitment: decode_blobs, the elements and z
    in Montgomery form, evaluate, quotient, and y and q back to plain form.
    Returns (ok (B,), y plain (B, 16), q plain (B, N, 16))."""
    elements, ok = decode_blobs(blob_bytes)
    elements_mont = fr_to_mont(elements)
    z_mont = fr_to_mont(z_plain)
    y_mont = evaluate(elements_mont, z_mont, roots)
    q_mont = quotient(elements_mont, z_mont, y_mont, roots, inv_roots)
    return ok, fr_from_mont(y_mont), fr_from_mont(q_mont)


def prove_chunk(blob_bytes, z_plain, roots, inv_roots, commit):
    """Each blob's proof at its point z: quotient_chunk, then the
    commitment of q and its compression.  Returns (ok (B,), y plain
    (B, 16), (B, 48) uint8 proofs); `commit` as for commit_chunk."""
    ok, y_plain, q_plain = quotient_chunk(blob_bytes, z_plain, roots, inv_roots)
    return ok, y_plain, compress.g1_compress_planes(commit(q_plain))


@dataclass(frozen=True)
class Scan:
    """A program in the form of the JAX package's lax.scan programs:
    head(*inputs) -> (carry, xs, extras), then carry = step(carry, x) for
    each x of xs along its leading axis, in order, then tail(carry,
    *extras) -> the outputs; carry and extras are tuples of tensors, xs a
    tensor.  Called, it runs eagerly; graphs.py captures the head, the step
    and the tail as three CUDA graphs and replays the step's graph once an
    x.  Scans of one graph cache whose `step_name` is the same run the same
    step on the same tensors, so they share one step graph a batch size."""

    head: Callable
    step: Callable
    tail: Callable
    step_name: str | None = None

    def __call__(self, *inputs):
        carry, xs, extras = self.head(*inputs)
        for x in xs:
            carry = self.step(carry, x)
        return self.tail(carry, *extras)


def _commit_head(blob_bytes, n_points: int, window: int):
    elements, ok = decode_blobs(blob_bytes)
    acc, digits = msm.window_start(elements, n_points, window)
    return acc, digits, (ok,)


def _prove_head(blob_bytes, z_plain, roots, inv_roots, n_points: int, window: int):
    # quotient_chunk over the window step's row slices: its full-width Fr
    # temporaries (0.27 GB blocks at 64 mainnet blobs) then fit in the
    # pool blocks that the step's capture leaves free; each blob's values
    # are its own
    parts = [quotient_chunk(blob_bytes[s], z_plain[s], roots, inv_roots)
             for s in cuda_msm.row_slices(blob_bytes.shape[0])]
    ok, y_plain, q_plain = (torch.cat(t) for t in zip(*parts))
    acc, digits = msm.window_start(q_plain, n_points, window)
    return acc, digits, (ok, y_plain)


def _compress_tail(acc, *extras):
    return (*extras, compress.g1_compress_planes(acc))


def _window_step_name(window: int) -> str:
    """The step name of commit_scan and prove_scan: both step
    msm.window_step over the same padded setup points."""
    return f"msm.window_step c={window}"


def commit_scan(g1_points, window: int = 8) -> Scan:
    """commit_chunk with commit_msm bound, as a Scan over the windows, MSB
    first: the head decodes the blobs and gives the identity accumulator
    and the window digits (msm.window_start), the step is
    msm.window_step, the tail compresses the sums.  Gives commit_chunk's
    outputs bit for bit."""
    points = msm.pad_points(g1_points)
    return Scan(functools.partial(_commit_head, n_points=points[0].shape[0], window=window),
                functools.partial(msm.window_step, points, c=window), _compress_tail,
                _window_step_name(window))


def prove_scan(g1_points, roots, inv_roots, window: int = 8) -> Scan:
    """prove_chunk with commit_msm bound, as a Scan over the windows of q:
    the head is quotient_chunk and msm.window_start of q, the step (of
    commit_scan's name: a graph cache captures it once for both) and the
    tail are commit_scan's.  Gives prove_chunk's outputs bit for bit."""
    points = msm.pad_points(g1_points)
    return Scan(functools.partial(_prove_head, roots=roots, inv_roots=inv_roots,
                                  n_points=points[0].shape[0], window=window),
                functools.partial(msm.window_step, points, c=window), _compress_tail,
                _window_step_name(window))


#: the torch dtype of each numpy dtype that to_device takes
_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int64): torch.int64}


def to_device(arrays, device) -> list[torch.Tensor]:
    """Host arrays (uint8 or int64) on `device` in one copy: packed into
    one host buffer at 8-byte aligned offsets, copied, and split into views
    of the arrays' shapes and dtypes.  For a CUDA device the buffer is
    pinned and the copy asynchronous, so the host goes on at once; PyTorch's
    caching host allocator reuses a pinned block only after its copy has
    run.  On the CPU the views are of the fresh buffer itself."""
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // 8) * 8
    device = torch.device(device)
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=device.type == "cuda")
    host_view = buf.numpy()
    for a, o in zip(arrays, offsets):
        host_view[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    on_dev = buf.to(device, non_blocking=True)
    return [on_dev[o:o + a.nbytes].view(_DTYPES[a.dtype]).view(a.shape)
            for a, o in zip(arrays, offsets)]


def fr_planes_host(vals) -> np.ndarray:
    """Python ints -> (len, 16) PLAIN Fr digit planes of their residues
    mod r, as a host array."""
    raw = b"".join((v % host.R).to_bytes(32, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u2").reshape(-1, FR.n_digits).astype(np.int64)


def fr_planes(vals, device) -> torch.Tensor:
    """Python ints -> (len, 16) PLAIN Fr digit planes on `device`."""
    return to_device([fr_planes_host(vals)], device)[0]
