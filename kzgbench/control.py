#!/usr/bin/env python3
"""The check's control and its planted faults: the reference put in the
program's place (kzgbench/reference/port.py) with one guarantee of the
configuration broken, which the check has to find not correct.

The configurations state no precision, so the control breaks a stated
guarantee, the step that would tempt a later change:

* unsound (the verify cells): a verifier that skips the opening check and
  accepts every input that decodes;
* unbound (the submit cells): blob proofs at the Fiat-Shamir challenge of
  a placeholder commitment (the point at infinity), as a change that
  proves without waiting for the commitments would.

The faults, each a wrapper of a sound stand-in: an answer altered where it
is produced, half of each batch left out, and a call that returns the
state of the one before.  kzgbench/tests/test_kzgbench_control.py runs
them all at a small size; on the card, at the cell's own size:

  python3 kzgbench/control.py --workload <cell> --seeds 11 12 13 --seconds 10"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kzgbench import harness, program  # noqa: E402
from kzgbench.reference import g1  # noqa: E402
from kzgbench.reference.port import ReferenceKzg  # noqa: E402


class Unsound(ReferenceKzg):
    def _opening(self, commitment: bytes, z: int, y: int, proof: bytes) -> bool:
        g1.decompress(commitment)
        g1.decompress(proof)
        return True


class Unbound(ReferenceKzg):
    def compute_blob_kzg_proofs(self, blobs, commitments):
        return super().compute_blob_kzg_proofs(blobs, [g1.INFINITY_BYTES] * len(blobs))


class _Fault:
    """A sound stand-in with a fault planted in its outputs."""

    def __init__(self, inner: ReferenceKzg):
        self.inner = inner

    def __getattr__(self, name):
        call = getattr(self.inner, name)
        return lambda *args: self.plant(name, args, call)


class Altered(_Fault):
    """The first verdict, or the first commitment's last byte, of each call
    altered where it is produced."""

    def plant(self, name, args, call):
        out = call(*args)
        if isinstance(out, bool):
            return not out
        if name == "verify_blob_kzg_proof_batches":
            return [not out[0]] + out[1:]
        if name == "blobs_to_kzg_commitments":
            return [out[0][:-1] + bytes([out[0][-1] ^ 1])] + out[1:]
        return out


class HalfBatch(_Fault):
    """Half of each batch left out: a batch verified on its first half, a
    submission's second half given the first half's outputs."""

    def plant(self, name, args, call):
        if name == "verify_blob_kzg_proof_batches":
            return call([[x[:max(1, len(x) // 2)] for x in batch] for batch in args[0]])
        if name in ("blobs_to_kzg_commitments", "compute_blob_kzg_proofs"):
            half = max(1, len(args[0]) // 2)
            out = call(*(a[:half] for a in args))
            return (out * 2)[:len(args[0])]
        return call(*args)


class Stale(_Fault):
    """A call that returns its state unchanged: each call after the first
    gets the first call's outputs."""

    def __init__(self, inner):
        super().__init__(inner)
        self.first = {}

    def plant(self, name, args, call):
        if name not in self.first:
            self.first[name] = call(*args)
        return self.first[name]


CONTROLS = {"unsound": Unsound, "unbound": Unbound}
FAULTS = {"altered": Altered, "half_batch": HalfBatch, "stale": Stale}


def control_for(entry: str) -> str:
    return "unbound" if entry == "submit" else "unsound"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of a cell's check, at the cell's size")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--control", choices=sorted(CONTROLS))
    args = ap.parse_args(argv)
    from kzgbench import manifest

    m = manifest.load()
    entry = manifest.traffic(manifest.workload(m, args.workload)["traffic"])["entry"]
    kind = args.control or control_for(entry)
    for seed in args.seeds:
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               lambda config, root: program.StandIn(CONTROLS[kind]()),
                               log=lambda msg: print(msg, file=sys.stderr, flush=True))
        print(json.dumps({"workload": args.workload, "control": kind, "seed": seed,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
