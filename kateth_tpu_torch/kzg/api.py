"""Byte-level batch blob-proof verification.

Invalid encodings, non-canonical field elements and off-curve or
out-of-subgroup points raise KzgError; `False` is returned only for an
honest verification failure.  The host prefix (length checks, SHA-256
Fiat-Shamir challenges, the batch challenge r and its weights) runs in
Python; the rest runs on the setup's device.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import host
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

    def __init__(self, setup: TorchSetup):
        self.setup = setup
        self.config = setup.config
        self.device = setup.device

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

    # -- verification -------------------------------------------------------

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

        def dev_bytes(data: bytes, width: int) -> torch.Tensor:
            arr = np.frombuffer(data, dtype=np.uint8).reshape(nc, width)
            return torch.as_tensor(arr.copy()).to(self.device)

        blob_arr = dev_bytes(joined_blobs + b"\x00" * (nbytes * pad), nbytes)
        comm_arr = dev_bytes(joined_comms + _G1_GEN_BYTES * pad, BYTES_PER_COMMITMENT)
        proof_arr = dev_bytes(joined_proofs + _G1_GEN_BYTES * pad, BYTES_PER_PROOF)

        z_digests = self._challenge_digests(joined_blobs, joined_comms, n)
        z_vals = [int.from_bytes(d, "big") % host.R for d in z_digests] + [0] * pad
        r = self._rlc_challenge(z_digests, joined_comms, joined_proofs, n)
        weights = [pow(r, i, host.R) for i in range(n)] + [0] * pad
        zw = [w * z % host.R for w, z in zip(weights, z_vals)]
        planes = [protocol.fr_planes(v, self.device) for v in (z_vals, zw, weights)]
        return n, (blob_arr, comm_arr, proof_arr, *planes, self.setup.roots, self.setup.tau2)

    def _verify_batch_dispatch(self, blobs, commitments, proofs):
        """Host prefix and device work; returns (n, verdict, packed masks)
        with the device results not yet read back."""
        n, args = self._verify_batch_stage(blobs, commitments, proofs)
        if n == 0:
            return 0, None, None
        pc_in, packed = protocol.verify_blob_batch_fused(*args)
        return n, protocol.pairing_check(*pc_in)[0], packed

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
