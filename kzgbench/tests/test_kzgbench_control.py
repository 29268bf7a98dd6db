"""The check that decides `correct`, driven through a whole run with the
card's look skipped: the reference in the program's place is correct,
and its control and every fault a cell can have are found not correct.
The cells' traffic is cut to a few blobs so that the reference, at the
real 4096-element blobs, runs in seconds on the CPU; on the card the
control runs at the cells' own size (kzgbench/control.py)."""

from __future__ import annotations

import pytest

from kzgbench import control, harness, program
from kzgbench.reference.port import ReferenceKzg

SMALL = {
    "verify-stream": {"entry": "verify_blob_kzg_proof_batches", "loop": "closed", "pool": 8,
                      "blobs_per_batch": 3, "batches_per_call": 4, "bad_batches_per_call": 1,
                      "trace_seconds": 1},
    "submit-comb": {"entry": "submit", "loop": "closed", "pool": 6, "blobs_per_call": 4,
                    "trace_seconds": 1},
    "submit-windowed": {"entry": "submit", "loop": "closed", "pool": 6, "blobs_per_call": 2,
                        "trace_seconds": 1},
    "precompile": {"entry": "verify_kzg_proof", "loop": "closed", "pool": 16, "bad_share": [1, 4],
                   "warmup_calls": 2, "trace_seconds": 1},
}
#: the faults each cell can have (a single opening has no half to leave out)
FAULTS = {cell: sorted(control.FAULTS) for cell in SMALL}
FAULTS["precompile"] = ["altered", "stale"]


def run(cell: str, kzg, seed: int = 2**31 + 11, traced: bool = False) -> dict:
    return harness.run_cell(cell, seed, 0.6, traced, lambda config, root: program.StandIn(kzg),
                            params=dict(SMALL[cell]), log=lambda msg: None)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_reference_in_the_programs_place_is_correct(cell):
    out = run(cell, ReferenceKzg())
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert all(c["value"] == 0 == c["limit"] for c in out["checks"].values())
    e2e = {"verify-stream": "proofs_verified_per_s", "precompile": "latency_p95_ms",
           "submit-comb": "blobs_submitted_per_s",
           "submit-windowed": "blobs_submitted_per_s.windowed"}[cell]
    assert set(out["metrics"]) == {e2e, "setup_s"}  # no peak without a card


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(cell):
    kind = control.control_for(SMALL[cell]["entry"])
    out = run(cell, control.CONTROLS[kind]())
    assert not out["correct"]
    assert sum(c["value"] for c in out["checks"].values()) > 0


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(SMALL) for f in FAULTS[c]])
def test_each_fault_is_not_correct(cell, fault):
    out = run(cell, control.FAULTS[fault](ReferenceKzg()))
    assert not out["correct"]


def test_a_call_that_raises_is_failed_and_not_correct():
    class Raises(ReferenceKzg):
        """Raises on every call after the set-up's two."""

        calls = 0

        def verify_kzg_proof(self, *args):
            self.calls += 1
            if self.calls > SMALL["precompile"]["warmup_calls"]:
                raise ValueError("planted")
            return super().verify_kzg_proof(*args)

    out = run("precompile", Raises())
    assert not out["correct"] and out["failed"] == out["attempted"] > 0
    assert out["checks"]["calls_failed"]["value"] == out["attempted"]


def test_calls_repeat_from_the_seed():
    from kzgbench.generator import Traffic
    from kzgbench.reference import g1
    from kzgbench.reference.kzg import KnownTau

    ref, base = KnownTau(), g1.FixedBase()

    def first(seed, k=3):
        gen = Traffic(dict(SMALL["verify-stream"]), seed, ref, base).calls()
        return [next(gen).picks for _ in range(k)]

    assert first(2**40 + 1) == first(2**40 + 1) != first(2**40 + 2)
    calls = first(5, 10)
    assert all(len(c) == 4 for c in calls)
    # one batch in each call has two proofs swapped
    assert all(sum(bl != pr for bl, pr in c) == 1 for c in calls)
