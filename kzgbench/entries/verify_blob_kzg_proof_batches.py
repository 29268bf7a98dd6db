"""verify_blob_kzg_proof_batches over a pool of valid triples.

Parameters: "pool" valid (blob, commitment, proof) triples; a call passes
"batches_per_call" batches, each "blobs_per_batch" distinct blobs of the
pool in a seeded order; "bad_batches_per_call" batches of a call, at
seeded places, have two proofs swapped, so their verdict is False."""

from __future__ import annotations

from ..generator import BlobPool, Call


class Entry:
    def __init__(self, params: dict, ref, base, rng):
        self.p, self.ref = params, ref
        self.pool = BlobPool(params["pool"], ref, base, rng)

    def draw(self, rng) -> Call:
        per_call, size = self.p["batches_per_call"], self.p["blobs_per_batch"]
        bad = set(rng.choice(per_call, size=self.p["bad_batches_per_call"], replace=False).tolist())
        picks = []
        for b in range(per_call):
            blobs = rng.choice(len(self.pool.blobs), size=size, replace=False).tolist()
            proofs = list(blobs)
            if b in bad:
                i, j = rng.choice(size, size=2, replace=False).tolist()
                proofs[i], proofs[j] = proofs[j], proofs[i]
            picks.append((blobs, proofs))
        pool = self.pool
        args = tuple(([pool.blobs[i] for i in bl], [pool.commitments[i] for i in bl],
                      [pool.proofs[i] for i in pr]) for bl, pr in picks)
        return Call(args, picks, {"proofs": per_call * size}, per_call)

    def run(self, kzg, call: Call, span):
        with span():
            return kzg.verify_blob_kzg_proof_batches(list(call.args))

    def judge(self, call: Call) -> dict:
        """verdicts_wrong: verdicts other than the reference's, which holds
        a batch valid iff each of its openings is, by its scalars."""
        pool, want = self.pool, []
        for blobs, proofs in call.picks:
            want.append(all(self.ref.valid(pool.c[b], pool.z[b], pool.y[b], pool.pi[p])
                            for b, p in zip(blobs, proofs)))
        got = call.outputs
        wrong = len(want) if not isinstance(got, list) or len(got) != len(want) else \
            sum(g is not w for g, w in zip(got, want))
        return {"verdicts_wrong": wrong, "verdicts_false": want.count(False)}
