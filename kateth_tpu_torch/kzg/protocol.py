"""The device half of batch blob-proof verification.

* decode_blobs            -- per-element canonicality of the blobs
* evaluate                -- barycentric evaluation with no field inversion
* verify_blob_batch_fused -- decode, G1 decompression, evaluation and one
                             G1 ladder carrying the random-linear-combination
                             lincombs and the subgroup checks
* pairing_check           -- e(a1, a2) == e(b1, [1]_2)

Special cases are masks, not control flow.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves import decompress, ops
from ..curves import g1 as g1mod
from ..curves import g2 as g2mod
from ..curves import msm
from ..fields import cuda_mont
from ..fields import limbs as L
from ..fields.specs import FR
from .. import host, pairing

F1 = ops.FP_FIELD
_R_DIGITS = L.int_to_digits(FR.modulus, FR.n_digits)


def decode_blobs(blob_bytes: torch.Tensor):
    """(B, 32 N) uint8 -> (elements_plain (B, N, 16), ok (B,)): ok[b] iff
    every 32-byte chunk of blob b is a canonical big-endian Fr."""
    B = blob_bytes.shape[0]
    digits = L.be_bytes_to_digits(FR, blob_bytes.reshape(B, -1, 32))
    return digits, L.lt_modulus(FR, digits).all(-1)


def _scan_mul(x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Inclusive prefix (or suffix) products along axis -2, Hillis-Steele:
    log2(n) rounds of one batched Montgomery multiply each."""
    n = x.shape[-2]
    one = FR.tensor("one_mont", x.device)
    shift = 1
    while shift < n:
        ones = one.expand(*x.shape[:-2], shift, FR.n_digits)
        if reverse:
            shifted = torch.cat([x[..., shift:, :], ones], dim=-2)
        else:
            shifted = torch.cat([ones, x[..., : n - shift, :]], dim=-2)
        x = L.mont_mul(FR, x, shifted)
        shift *= 2
    return x


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
    prefix = _scan_mul(safe, reverse=False)
    suffix = _scan_mul(safe, reverse=True)
    ones = one.expand(safe.shape[0], 1, FR.n_digits)
    prefix_shift = torch.cat([ones, prefix[:, : n - 1]], dim=1)
    suffix_shift = torch.cat([suffix[:, 1:], ones], dim=1)
    fw = L.mont_mul(FR, elements_mont, roots.expand_as(elements_mont))
    terms = L.mont_mul(FR, L.mont_mul(FR, fw, prefix_shift), suffix_shift)
    s = L.sum_mod(FR, terms, axis=-2)
    ninv = torch.as_tensor(FR.from_int(pow(n, host.R - 2, host.R)), device=s.device)
    y = L.mont_mul(FR, s, ninv.expand_as(s))
    return torch.where(any_hit[..., None], y_hit, y)


def pairing_check(a1, a2, b1):
    """e(a1, a2) == e(b1, [1]_2) per leading index of the points."""
    dev = a1[0].device
    B = a1[0].shape[0]
    g2gen = tuple(torch.as_tensor(g, device=dev).expand(B, *g.shape) for g in g2mod.GENERATOR)
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
    neg_g1 = ops.pneg(F1, tuple(torch.as_tensor(g, device=dev)[None] for g in g1mod.GENERATOR))
    lanes = tuple(
        torch.cat([p, c, p, g, c, p]) for p, c, g in zip(proof_pt, comm_pt, neg_g1)
    )
    r = torch.as_tensor(_R_DIGITS, device=dev).expand(2 * B, FR.n_digits)
    sc = torch.cat([w_plain, w_plain, zw_plain, s_plain[None], r])
    prods = cuda_mont.g1_scalar_mul(lanes, sc)
    lin = tuple(a[: 3 * B].reshape(3, B, *a.shape[1:]) for a in prods)
    sums = msm.tree_sum(F1, lin, axis=1)
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


def fr_planes(vals, device) -> torch.Tensor:
    """Python ints -> (len, 16) PLAIN Fr digit planes on `device`."""
    return torch.as_tensor(np.stack([FR.from_int(v, mont=False) for v in vals])).to(device)
