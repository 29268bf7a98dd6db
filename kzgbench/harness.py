"""One run of one cell: the reference's inputs from the seed, the program's
set-up and warm-up, the measured (or traced) window, the check that
decides `correct`, and the metrics by their readers."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

from . import manifest, trace
from .generator import Call, Traffic
from .reference import g1
from .reference.kzg import TAU, KnownTau

#: each number the check compares, with its limit: every comparison is
#: exact, so every limit is 0 (PERF.md gives the readings)
LIMITS = {"calls_failed": 0, "verdicts_wrong": 0, "commitments_wrong": 0, "proofs_wrong": 0}


@dataclass
class Ctx:
    """What the metric readers read."""

    calls: list
    window_s: float
    setup_s: float
    peak_bytes: int
    trace: trace.Summary | None
    trace_ops: int
    shape: dict


def judge(traffic: Traffic, calls: list[Call]) -> tuple[dict, dict]:
    """(checks, notes): each number compared with its limit, summed over
    every call of the window, and what else the check read."""
    sums = {"calls_failed": 0}
    notes = {"calls_judged": len(calls)}
    for call in calls:
        if call.error is not None:
            sums["calls_failed"] += 1
        for k, v in traffic.entry.judge(call).items():
            target = sums if k in LIMITS else notes
            target[k] = target.get(k, 0) + v
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in sums.items()}, notes


def shape(params: dict, config: dict) -> dict:
    """The cell's shapes for the roofline counts: the blobs of a batch or
    of a commit (a call of more than 64 blobs commits in chunks of 64, the
    library's chunk, one launch each) and the configuration's sizes."""
    kc = config["kzg_config"]
    size = params.get("blobs_per_batch", params.get("blobs_per_call", 1))
    if params["entry"] == "submit":
        size = min(size, 64)
    return {"batch": size, "n": kc["n"], "comb_h": kc["comb_h"], "msm_window": kc["msm_window"]}


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool, make_program,
             root: str = manifest.ROOT, params: dict | None = None, log=print) -> dict:
    """One run: returns the result's fields (correct, attempted, failed,
    metrics, device, optionally breakdown, checks last).  make_program
    (config, root) builds the system under test (program.Port on the card);
    params replaces the cell's traffic file."""
    m = manifest.load(root)
    cell = manifest.workload(m, cell_name)
    config = manifest.config(m, cell["config"], root)
    params = params or manifest.traffic(cell["traffic"])

    t = time.perf_counter()
    ref = KnownTau(TAU, config["FIELD_ELEMENTS_PER_BLOB"])
    traffic = Traffic(params, seed, ref, g1.FixedBase())
    log(f"reference inputs: {time.perf_counter() - t:.3f} s (not in setup_s)")

    t = time.perf_counter()
    program = make_program(config, root)
    for call in traffic.warmup():
        traffic.entry.run(program.kzg, call, contextlib.nullcontext)
    program.synchronize()
    setup_s = time.perf_counter() - t

    summary = None
    if traced:
        with trace.profiled(program.cuda) as prof:
            calls, window_s = traffic.loop.drive(traffic, program.kzg, min(seconds, params["trace_seconds"]),
                                                  trace.span)
        t = time.perf_counter()
        summary = trace.summarize(prof)
        del prof
        log(f"trace reduced in {time.perf_counter() - t:.3f} s")
    else:
        calls, window_s = traffic.loop.drive(traffic, program.kzg, seconds, contextlib.nullcontext)
    peak, device = program.peak_bytes(), program.device()
    program.close()

    checks, notes = judge(traffic, calls)
    ctx = Ctx(calls, window_s, setup_s, peak, summary, sum(c.ops for c in calls), shape(params, config))
    metrics = {}
    for entry in manifest.cell_metrics(m, cell_name, traced):
        spec = manifest.metric(entry["name"])
        value = manifest.reader(spec.pop("reader")).read(ctx, **spec)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device["memory_peak_bytes"] = peak
    if summary is not None:
        device["busy_s"] = summary.busy_ns / 1e9
        device["window_s"] = summary.window_ns / 1e9
    failed = sum(c.error is not None for c in calls)
    for c in calls:
        if c.error is not None:
            log(f"call failed: {c.error}")
            break
    lat = sorted((c.end - c.start) * 1e3 for c in calls)
    median = lat[(len(lat) - 1) // 2] if lat else float("nan")
    log(f"window: {len(calls)} calls in {window_s!r} s, median latency {median!r} ms; {notes}")
    log("latencies (ms) of the first and last calls: "
        + " ".join(f"{(c.end - c.start) * 1e3:.2f}" for c in calls[:6]) + " ... "
        + " ".join(f"{(c.end - c.start) * 1e3:.2f}" for c in calls[-6:]))
    correct = bool(calls) and all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": len(calls), "failed": failed,
           "metrics": metrics, "device": device}
    if summary is not None:
        out["breakdown"] = summary.breakdown()
    out["checks"] = checks
    return out
