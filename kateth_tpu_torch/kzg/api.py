"""The byte-level KZG operations: commitments, proofs, single-point and
batch blob-proof verification, and the conversion of blobs to monomial
coefficients and back.

Invalid encodings, non-canonical field elements and off-curve or
out-of-subgroup points raise KzgError; `False` is returned only for an
honest verification failure.  The host prefix (length checks, SHA-256
Fiat-Shamir challenges, the batch challenge r and its weights) runs in
Python; the rest runs on the setup's device.  Every batched operation pads
its batch to a multiple of config.canon_batch (zero blobs, generator
points), so the device sees a fixed set of shapes.  Host data reaches a
CUDA device by asynchronous copies from pinned memory.

On a CUDA device the batch verification runs as one CUDA graph per padded
batch size (graphs.py), captured at the first batch of that size; the
dispatch of a batch never waits for the device, so streaming overlaps a
batch's host prefix with the device work of the batches before it.  CPU
tensors run the same program eagerly.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import graphs, host, ntt
from ..curves import compress, comb, decompress
from ..fields.specs import FR
from ..host import KzgError
from . import protocol
from .config import MAINNET, KzgConfig
from .setup import DEFAULT_CACHE_DIR, TorchSetup

BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_COMMITMENT = 48
BYTES_PER_PROOF = 48

#: the compressed G1 generator: the always-valid pad point of a batch
_G1_GEN_BYTES = host.g1_compress(host.G1_GEN)


class Kzg:
    """The library handle: a trusted setup on one device."""

    #: blobs per commit: a larger batch commits in chunks of this many
    commit_chunk = 64

    def __init__(self, setup: TorchSetup):
        self.setup = setup
        self.config = setup.config
        self.device = setup.device
        #: the fixed-base comb table, built at the first commit (6.4 GB on
        #: the card at mainnet), never for a caller who only verifies
        self._comb_table = None
        #: the batch verification's CUDA graphs of this setup (None on the
        #: CPU, which runs the program eagerly)
        self._verify_graphs = (graphs.VerifyBatchGraphs(setup.roots, setup.tau2)
                               if self.device.type == "cuda" else None)

    @classmethod
    def load_json(
        cls, path: str, config: KzgConfig = MAINNET, device=None,
        cache_dir: str | None = DEFAULT_CACHE_DIR,
    ) -> "Kzg":
        """Load a trusted-setup JSON onto `device`: CUDA by default, and an
        error when there is no CUDA device unless the caller names one."""
        return cls(TorchSetup.load_json(path, config, device, cache_dir))

    def _canon(self, n: int) -> int:
        """The padded batch size: the next multiple of config.canon_batch."""
        cb = self.config.canon_batch
        return cb * -(-max(n, 1) // cb)

    def _challenge_digests(self, joined_blobs: bytes, joined_comms: bytes, n: int):
        """Per-blob Fiat-Shamir digests H(domain || n || blob_i || comm_i)."""
        prefix = host.FS_DOMAIN + self.config.n.to_bytes(16, "big")
        nb = self.config.bytes_per_blob
        return [
            hashlib.sha256(
                prefix + joined_blobs[i * nb : (i + 1) * nb] + joined_comms[i * 48 : (i + 1) * 48]
            ).digest()
            for i in range(n)
        ]

    def _rlc_challenge(self, z_digests, joined_comms: bytes, joined_proofs: bytes, n: int) -> int:
        """The batch challenge r: it binds every input, the blobs through
        their fixed-width challenge digests, so predictable weights cannot
        let two invalid triples cancel."""
        return host.hash_to_fr(
            host.RC_DOMAIN
            + self.config.n.to_bytes(16, "big")
            + n.to_bytes(16, "big")
            + b"".join(z_digests)
            + joined_comms
            + joined_proofs
        )

    # -- host codecs ----------------------------------------------------------

    def _to_device(self, data: bytes, width: int) -> torch.Tensor:
        return protocol.to_device([np.frombuffer(data, dtype=np.uint8).reshape(-1, width)],
                                  self.device)[0]

    def _decode_blobs(self, blobs, pad_to: int | None = None):
        """list[bytes] -> (plain element planes (B, N, 16), ok (B,)) on the
        device.  Length errors raise here; canonicality comes back as a
        mask.  With pad_to, zero blobs pad the batch; callers slice [:n]."""
        nbytes = self.config.bytes_per_blob
        for b in blobs:
            if len(b) != nbytes:
                raise KzgError("invalid blob length")
        pad = max(0, (pad_to or 0) - len(blobs))
        joined = b"".join(bytes(b) for b in blobs) + b"\x00" * (nbytes * pad)
        return protocol.decode_blobs(self._to_device(joined, nbytes))

    @staticmethod
    def _check_ok(ok: torch.Tensor) -> None:
        if not bool(ok.all()):
            raise KzgError("non-canonical field element in blob")

    @staticmethod
    def _fr_bytes_to_int(b: bytes) -> int:
        if len(b) != BYTES_PER_FIELD_ELEMENT:
            raise KzgError("invalid field element length")
        v = int.from_bytes(bytes(b), "big")
        if v >= host.R:
            raise KzgError("non-canonical field element")
        return v

    def _challenges(self, blobs, commitments) -> list[int]:
        """Fiat-Shamir challenges of (blob, commitment) pairs, mod r."""
        digests = self._challenge_digests(
            b"".join(bytes(b) for b in blobs), b"".join(bytes(c) for c in commitments), len(blobs)
        )
        return [int.from_bytes(d, "big") % host.R for d in digests]

    # -- commitments and proofs ------------------------------------------------

    def _commit_one(self, chunk: torch.Tensor):
        """One commit of (commit_chunk or fewer, N, 16) plain scalars: the
        fixed-base comb, or the windowed Pippenger when comb_h = 0."""
        h = self.config.comb_h
        if h == 0:
            return protocol.commit_msm(self.setup.g1_points, chunk, self.config.msm_window)
        if self._comb_table is None:
            self._comb_table = comb.build_table(self.setup.g1_points, h)
        return protocol.commit_comb(self._comb_table, chunk, h, self.config.n)

    def _commit_elements(self, elements_plain: torch.Tensor):
        B = elements_plain.shape[0]
        if B <= self.commit_chunk:
            return self._commit_one(elements_plain)
        outs = []
        for i in range(0, B, self.commit_chunk):
            chunk = elements_plain[i : i + self.commit_chunk]
            n = chunk.shape[0]
            if n < self.commit_chunk:
                chunk = torch.cat([chunk, chunk.new_zeros(self.commit_chunk - n, *chunk.shape[1:])])
            outs.append(tuple(c[:n] for c in self._commit_one(chunk)))
        return tuple(torch.cat([o[i] for o in outs]) for i in range(3))

    def _evaluate_and_quotient(self, elements_plain: torch.Tensor, z_vals):
        """(B, N, 16) plain elements and z ints -> (y ints, plain quotient)."""
        elements_mont = protocol.fr_to_mont(elements_plain)
        z_mont = protocol.fr_to_mont(protocol.fr_planes(z_vals, self.device))
        y_mont = protocol.evaluate(elements_mont, z_mont, self.setup.roots)
        q_mont = protocol.quotient(
            elements_mont, z_mont, y_mont, self.setup.roots, self.setup.inv_roots
        )
        y_plain = protocol.fr_from_mont(y_mont).cpu().numpy()
        ys = [FR.to_int(row, mont=False) for row in y_plain]
        return ys, protocol.fr_from_mont(q_mont)

    def blob_to_kzg_commitment(self, blob: bytes) -> bytes:
        return self.blobs_to_kzg_commitments([blob])[0]

    def blobs_to_kzg_commitments(self, blobs) -> list[bytes]:
        n = len(blobs)
        elements, ok = self._decode_blobs(blobs, pad_to=self._canon(n))
        self._check_ok(ok[:n])
        return compress.points_to_bytes(self._commit_elements(elements))[:n]

    def compute_kzg_proof(self, blob: bytes, z: bytes) -> tuple[bytes, bytes]:
        (proof,), (y,) = self.compute_kzg_proofs([blob], [z])
        return proof, y

    def compute_kzg_proofs(self, blobs, zs):
        """Proofs of each blob's polynomial at its point z: (proofs, ys),
        lists of bytes."""
        if len(blobs) != len(zs):
            raise KzgError("length mismatch")
        n = len(blobs)
        nc = self._canon(n)
        elements, ok = self._decode_blobs(blobs, pad_to=nc)
        self._check_ok(ok[:n])
        z_vals = [self._fr_bytes_to_int(z) for z in zs] + [0] * (nc - n)
        ys, q_plain = self._evaluate_and_quotient(elements, z_vals)
        proofs = compress.points_to_bytes(self._commit_elements(q_plain))[:n]
        return proofs, [v.to_bytes(32, "big") for v in ys[:n]]

    def compute_blob_kzg_proof(self, blob: bytes, commitment: bytes) -> bytes:
        return self.compute_blob_kzg_proofs([blob], [commitment])[0]

    def _validate_g1_device(self, points) -> None:
        """Full decompression of the points on the device, the subgroup
        check by kernel K3 included; the batch pads with generator bytes."""
        for p in points:
            if len(p) != BYTES_PER_COMMITMENT:
                raise KzgError("invalid point length")
        n = len(points)
        joined = b"".join(bytes(p) for p in points) + _G1_GEN_BYTES * (self._canon(n) - n)
        _, ok_enc, ok_curve, ok_sub = decompress.g1_decompress(
            self._to_device(joined, BYTES_PER_COMMITMENT)
        )
        masks = torch.stack([ok_enc, ok_curve, ok_sub])[:, :n].cpu().numpy()
        self._raise_point_masks(masks)

    def compute_blob_kzg_proofs(self, blobs, commitments) -> list[bytes]:
        """Blob proofs: each blob's proof at its Fiat-Shamir challenge.  The
        commitments are validated on the device before the blobs."""
        if len(blobs) != len(commitments):
            raise KzgError("length mismatch")
        self._validate_g1_device(commitments)
        n = len(blobs)
        nc = self._canon(n)
        elements, ok = self._decode_blobs(blobs, pad_to=nc)
        self._check_ok(ok[:n])
        z_vals = self._challenges(blobs, commitments) + [0] * (nc - n)
        _, q_plain = self._evaluate_and_quotient(elements, z_vals)
        return compress.points_to_bytes(self._commit_elements(q_plain))[:n]

    # -- polynomial form conversion (the NTT, ntt.py) ----------------------------

    @staticmethod
    def _fr_planes_to_byteslists(plain: torch.Tensor) -> list[list[bytes]]:
        """(B, N, 16) plain digit planes -> per-blob lists of 32-byte
        big-endian scalars, in one read-back and one byte conversion."""
        arr = plain.cpu().numpy()
        raw = arr[..., ::-1].astype(">u2").tobytes()  # most significant digit first
        B, N = arr.shape[:2]
        return [[raw[(b * N + i) * 32 : (b * N + i + 1) * 32] for i in range(N)] for b in range(B)]

    def blobs_to_coefficients(self, blobs) -> list[list[bytes]]:
        """Blobs (evaluations over the bit-reversed roots) -> monomial
        coefficients, ascending degree, 32-byte big-endian each."""
        n = len(blobs)
        elements, ok = self._decode_blobs(blobs, pad_to=self._canon(n))
        self._check_ok(ok[:n])
        cm = ntt.lagrange_brp_to_monomial(protocol.fr_to_mont(elements))
        return self._fr_planes_to_byteslists(protocol.fr_from_mont(cm))[:n]

    def coefficients_to_blobs(self, coeffs) -> list[bytes]:
        """Monomial coefficients (per-blob lists of 32-byte big-endian
        scalars, ascending degree) -> blobs.  A wrong count or a
        non-canonical coefficient raises KzgError."""
        for cs in coeffs:
            if len(cs) != self.config.n:
                raise KzgError("invalid coefficient count")
        joined = [b"".join(bytes(c) for c in cs) for cs in coeffs]
        n = len(joined)
        elements, ok = self._decode_blobs(joined, pad_to=self._canon(n))
        self._check_ok(ok[:n])
        ev = ntt.monomial_to_lagrange_brp(protocol.fr_to_mont(elements))
        return [b"".join(cs) for cs in self._fr_planes_to_byteslists(protocol.fr_from_mont(ev))[:n]]

    # -- verification -------------------------------------------------------

    def verify_kzg_proof(self, proof: bytes, commitment: bytes, z: bytes, y: bytes) -> bool:
        """Single-point verification: e(proof, [tau]_2 - z G2) ==
        e(C - y G1, G2).  The proof's errors are raised before the
        commitment's."""
        for b in (proof, commitment):
            if len(b) != BYTES_PER_COMMITMENT:
                raise KzgError("invalid point length")
        z_v = self._fr_bytes_to_int(z)
        y_v = self._fr_bytes_to_int(y)
        a1, a2, b1, proof_masks, comm_masks = protocol.verify_kzg_bytes(
            self._to_device(bytes(proof), BYTES_PER_PROOF),
            self._to_device(bytes(commitment), BYTES_PER_COMMITMENT),
            protocol.fr_planes([z_v], self.device),
            protocol.fr_planes([y_v], self.device),
            self.setup.tau2,
        )
        masks = torch.stack([*proof_masks, *comm_masks]).cpu().numpy()
        self._raise_point_masks(masks[:3])
        self._raise_point_masks(masks[3:])
        return bool(protocol.pairing_check(a1, a2, b1)[0])


    def verify_blob_kzg_proof(self, blob: bytes, commitment: bytes, proof: bytes) -> bool:
        return self.verify_blob_kzg_proof_batch([blob], [commitment], [proof])

    def verify_blob_kzg_proof_batch(self, blobs, commitments, proofs) -> bool:
        """Random-linear-combination batch verification with weights
        r^0 = 1, r, r^2, ..."""
        return self._verify_batch_finalize(self._verify_batch_dispatch(blobs, commitments, proofs))

    def verify_blob_kzg_proof_batches(self, batches) -> list[bool]:
        """Streaming batch verification: one verdict per (blobs,
        commitments, proofs) triple.  Every batch is dispatched to the
        device before any verdict is read back.  Errors are those a loop of
        verify_blob_kzg_proof_batch calls would raise: the earliest bad
        batch's, found at dispatch (lengths) or at finalize (canonicality,
        point validity), and then no verdicts are returned."""
        pendings = []
        dispatch_error: KzgError | None = None
        for b, c, p in batches:
            try:
                pendings.append(self._verify_batch_dispatch(b, c, p))
            except KzgError as e:
                dispatch_error = e
                break
        verdicts = [self._verify_batch_finalize(p) for p in pendings]
        if dispatch_error is not None:
            raise dispatch_error
        return verdicts

    def _verify_batch_stage(self, blobs, commitments, proofs):
        """Host prefix: validation, Fiat-Shamir, padded device transfers.
        Returns (n, arguments of protocol.verify_blob_batch_fused)."""
        if not (len(blobs) == len(commitments) == len(proofs)):
            raise KzgError("length mismatch")
        n = len(blobs)
        if n == 0:
            return 0, None
        nbytes = self.config.bytes_per_blob
        for b in blobs:
            if len(b) != nbytes:
                raise KzgError("invalid blob length")
        for p in list(commitments) + list(proofs):
            if len(p) != BYTES_PER_COMMITMENT:
                raise KzgError("invalid point length")

        # pad lanes: weight 0, a zero blob (canonical) and generator points
        # (valid, in the subgroup): they add the identity to every lincomb
        nc = self._canon(n)
        pad = nc - n
        joined_blobs = b"".join(bytes(b) for b in blobs)
        joined_comms = b"".join(bytes(c) for c in commitments)
        joined_proofs = b"".join(bytes(p) for p in proofs)

        z_digests = self._challenge_digests(joined_blobs, joined_comms, n)
        z_vals = [int.from_bytes(d, "big") % host.R for d in z_digests] + [0] * pad
        r = self._rlc_challenge(z_digests, joined_comms, joined_proofs, n)
        weights = [pow(r, i, host.R) for i in range(n)] + [0] * pad
        zw = [w * z % host.R for w, z in zip(weights, z_vals)]

        def rows(data: bytes, width: int) -> np.ndarray:
            return np.frombuffer(data, dtype=np.uint8).reshape(nc, width)

        staged = protocol.to_device([
            rows(joined_blobs + b"\x00" * (nbytes * pad), nbytes),
            rows(joined_comms + _G1_GEN_BYTES * pad, BYTES_PER_COMMITMENT),
            rows(joined_proofs + _G1_GEN_BYTES * pad, BYTES_PER_PROOF),
            *(protocol.fr_planes_host(v) for v in (z_vals, zw, weights)),
        ], self.device)
        return n, (*staged, self.setup.roots, self.setup.tau2)

    def _verify_batch_dispatch(self, blobs, commitments, proofs):
        """Host prefix and device work; returns (n, verdict, packed masks)
        with the device results not yet read back.  On CUDA the device work
        is a replay of this padded batch size's graph, captured at its first
        batch; nothing here waits for the device."""
        n, args = self._verify_batch_stage(blobs, commitments, proofs)
        if n == 0:
            return 0, None, None
        if self._verify_graphs is None:
            return n, *protocol.verify_blob_batch(*args)
        return n, *self._verify_graphs(args[:6])

    def _verify_batch_finalize(self, pending) -> bool:
        n, verdict, packed = pending
        if n == 0:
            return True
        m = packed[:, :n].cpu().numpy()  # pad lanes sliced off
        # blob canonicality first, then the commitments, then the proofs
        if not m[0].all():
            raise KzgError("non-canonical field element in blob")
        self._raise_point_masks(m[1:4])
        self._raise_point_masks(m[4:7])
        return bool(verdict)

    @staticmethod
    def _raise_point_masks(masks):
        """(ok_encoding, ok_curve, ok_subgroup) -> KzgError."""
        ok_enc, ok_curve, ok_sub = masks
        if not ok_enc.all():
            raise KzgError("invalid G1 point: BadEncoding")
        if not ok_curve.all():
            raise KzgError("invalid G1 point: NotOnCurve")
        if not ok_sub.all():
            raise KzgError("invalid G1 point: NotInGroup")
