"""verify_kzg_proof over a pool of openings: random c, z and y, the proof
made from tau, a share of them given y + 1.

Parameters: "pool" openings, of which "bad_share" [k, m] (k in m) carry
y + 1, so their verdict is False; a call is one opening of the pool."""

from __future__ import annotations

from ..generator import Call, random_fr
from ..reference.fields import R


class Entry:
    def __init__(self, params: dict, ref, base, rng):
        self.ref = ref
        size = params["pool"]
        k, m = params["bad_share"]
        self.c, self.z, y = random_fr(rng, size), random_fr(rng, size), random_fr(rng, size)
        self.pi = [ref.proof(c, z, v) for c, z, v in zip(self.c, self.z, y)]
        bad = set(rng.choice(size, size=size * k // m, replace=False).tolist())
        self.y = [(v + 1) % R if i in bad else v for i, v in enumerate(y)]
        comms, proofs = base.compress_many(self.c), base.compress_many(self.pi)
        self.args = [(proofs[i], comms[i], self.z[i].to_bytes(32, "big"), self.y[i].to_bytes(32, "big"))
                     for i in range(size)]

    def draw(self, rng) -> Call:
        i = int(rng.integers(len(self.args)))
        return Call(self.args[i], i, {"proofs": 1}, 1)

    def run(self, kzg, call: Call, span):
        with span():
            return [kzg.verify_kzg_proof(*call.args)]

    def judge(self, call: Call) -> dict:
        """verdicts_wrong: a verdict other than c - y = (tau - z) pi."""
        i = call.picks
        want = self.ref.valid(self.c[i], self.z[i], self.y[i], self.pi[i])
        got = call.outputs
        wrong = int(not isinstance(got, list) or len(got) != 1 or got[0] is not want)
        return {"verdicts_wrong": wrong, "verdicts_false": int(not want)}
