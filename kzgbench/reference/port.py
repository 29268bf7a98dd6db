"""The reference in the program's place: the library's public calls that
the traffic drives, computed in Python integers with the known tau, for
the control and for the tests of the harness on a machine without a card.

Verification needs no pairing: an opening (C, z, y, pi) of points holds
iff C - y G1 = (tau - z) pi, which this checks on the points themselves."""

from __future__ import annotations

from . import g1
from .fields import R
from .kzg import TAU, KnownTau, blob_scalars, compute_challenge


class ReferenceKzg:
    def __init__(self, tau: int = TAU, n: int = 4096):
        self.ref = KnownTau(tau, n)
        self.base = g1.FixedBase()

    def _opening(self, commitment: bytes, z: int, y: int, proof: bytes) -> bool:
        lhs = g1.add(g1.from_affine(g1.decompress(commitment)), g1.neg(self.base.mul(y)))
        rhs = g1.mul(g1.from_affine(g1.decompress(proof)), (self.ref.tau - z) % R)
        return g1.equal(lhs, rhs)

    def _challenge_point(self, blob: bytes, commitment: bytes) -> tuple[int, int]:
        z = compute_challenge(blob, commitment, self.ref.domain.n)
        return z, self.ref.domain.evaluate(blob_scalars(blob), z)

    def blobs_to_kzg_commitments(self, blobs) -> list[bytes]:
        return self.base.compress_many([self.ref.commitment(blob_scalars(b)) for b in blobs])

    def compute_blob_kzg_proofs(self, blobs, commitments) -> list[bytes]:
        scalars = []
        for blob, comm in zip(blobs, commitments):
            z, y = self._challenge_point(blob, comm)
            scalars.append(self.ref.proof(self.ref.commitment(blob_scalars(blob)), z, y))
        return self.base.compress_many(scalars)

    def verify_blob_kzg_proof_batch(self, blobs, commitments, proofs) -> bool:
        return all(self._opening(c, *self._challenge_point(b, c), p)
                   for b, c, p in zip(blobs, commitments, proofs))

    def verify_blob_kzg_proof_batches(self, batches) -> list[bool]:
        return [self.verify_blob_kzg_proof_batch(*batch) for batch in batches]

    def verify_blob_kzg_proof(self, blob: bytes, commitment: bytes, proof: bytes) -> bool:
        return self.verify_blob_kzg_proof_batch([blob], [commitment], [proof])

    def verify_kzg_proof(self, proof: bytes, commitment: bytes, z: bytes, y: bytes) -> bool:
        return self._opening(commitment, int.from_bytes(z, "big"), int.from_bytes(y, "big"), proof)
