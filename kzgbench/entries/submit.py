"""blobs_to_kzg_commitments, then compute_blob_kzg_proofs of the same
blobs and the commitments just returned.

Parameters: a call takes "blobs_per_call" distinct blobs of a pool of
"pool"."""

from __future__ import annotations

from ..generator import BlobPool, Call


class Entry:
    def __init__(self, params: dict, ref, base, rng):
        self.p = params
        self.pool = BlobPool(params["pool"], ref, base, rng)

    def draw(self, rng) -> Call:
        size = self.p["blobs_per_call"]
        picks = rng.choice(len(self.pool.blobs), size=size, replace=False).tolist()
        return Call(([self.pool.blobs[i] for i in picks],), picks, {"blobs": size}, 1)

    def run(self, kzg, call: Call, span):
        (blobs,) = call.args
        with span():
            comms = kzg.blobs_to_kzg_commitments(blobs)
        with span():
            proofs = kzg.compute_blob_kzg_proofs(blobs, comms)
        return comms, proofs

    def judge(self, call: Call) -> dict:
        """commitments_wrong and proofs_wrong: encodings other than the
        reference's p(tau) G1 and ((p(tau) - y)/(tau - z)) G1 bytes."""
        n = len(call.picks)
        comms, proofs = call.outputs if isinstance(call.outputs, tuple) else ([], [])
        want_c = [self.pool.commitments[i] for i in call.picks]
        want_p = [self.pool.proofs[i] for i in call.picks]
        return {"commitments_wrong": n if len(comms) != n else sum(a != b for a, b in zip(comms, want_c)),
                "proofs_wrong": n if len(proofs) != n else sum(a != b for a, b in zip(proofs, want_p))}
