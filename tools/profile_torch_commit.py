#!/usr/bin/env python3
"""Where a 64-blob commitment spends its time in the PyTorch/CUDA port, on
one GPU, on both commit paths.

Loads the mainnet setup and commits 64 copies of the vendored
`blob_to_kzg_commitment/valid_0` blob.  Every stage below is timed on the
host clock between two syncs, summed over the loop it sits in:
  1. the comb (comb_h = 12): the table build (seconds, peak device
     memory), then one commit by its stages: the row gather of all 22
     columns, kernel K8's one launch, the halving sum of every column's
     chain totals, and the 22 doublings and additions that combine the
     columns; then a commit's pieces run eagerly, by stage (blob
     decode, commit, compression and read-back; the library runs them as
     one CUDA graph) and compute_kzg_proofs' evaluation and quotient;
  2. the windowed Pippenger (comb_h = 0): one commit by its windows: the
     stable argsort and gather, kernel K7 alone, the rest of the two-level
     scan (its offset add at the bucket boundaries and the last point), the
     bucket-boundary indices and selects, the halving sum, the (2^c - 1)
     total, and the window sum with the doublings and addition between
     windows;
  3. one traced eager comb commit (torch.profiler): device busy share and
     launches;
  4. the device time of each stage of one eager 64-blob commit (decode,
     columns and gather, K8, halving sum, doublings and additions,
     compression), each stage traced alone after a warm-up and its
     kernels' durations summed: the device work a replay of the library's
     commit graph runs; and one traced library commit after a warm-up (a
     graph replay where the tree has one): its device busy time and
     operations;
  5. the same for the windowed commit (comb_h = 0): the device time of its
     head (blob decode and window digits), of each stage of every window
     step (the doublings, the argsort and gather, K7, the Hillis-Steele
     scan of the chain totals, the bucket-boundary indices and selects, the
     offset add of the two-level scan at the boundaries, the halving sum, the
     (2^c - 1) total, the window sum and its addition), each traced alone
     after a warm-up and summed over the W windows, and of its tail
     (compression): the device work the windowed commit's graph replays
     run; and one traced library windowed commit after a warm-up (graph
     replays where the tree has them).
The replays are checked against the library's own commits.  Prints one
JSON object with the card's name and power limit.

With --memory it measures device memory instead, on eager twins (a Kzg
with no graph cache, chip_smoke.eager_twin), each call warmed up once and
then run after a sync, an empty_cache and a reset of the peak statistics:
the peak bytes allocated (and reserved) above the baseline of a 64-blob
windowed commit and of 64-blob windowed compute_blob_kzg_proofs
(comb_h = 0), and of a 64-blob comb commit (the table apart); and a
memory-history snapshot of one eager msm.window_step at 64 blobs: its
peak, and the blocks live at the peak summed by the line of the port
that allocated them (the innermost frame in kateth_tpu_torch/) and by the
line of curves/msm.py or curves/cuda_msm.py it was called from.

Run from the root of a checkout: python3 tools/profile_torch_commit.py
[--memory].  The tool imports the checkout it sits in, so a copy of it in
another checkout's tools/ measures that checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def window_step_snapshot(points, acc, dig, c: int, dev) -> dict:
    """One eager msm.window_step under torch.cuda.memory's history: its
    peak allocated bytes above the baseline, and the blocks it allocated
    that are live at that peak, summed by the allocating line."""
    import torch

    from kateth_tpu_torch.curves import msm

    msm.window_step(points, acc, dig, c)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.memory._record_memory_history(enabled="all", context="all", stacks="python")
    try:
        msm.window_step(points, acc, dig, c)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    peak = torch.cuda.max_memory_allocated(dev) - base

    def where(frames):
        """(innermost port line, innermost line of the step's own modules)."""
        port = [f for f in frames if "kateth_tpu_torch" in f["filename"]]
        own = [f for f in port if f["filename"].endswith(("curves/msm.py", "curves/cuda_msm.py"))]

        def name(f):
            path = f["filename"][f["filename"].rindex("kateth_tpu_torch"):]
            return f"{path}:{f['line']} {f['name']}"

        return (name(port[0]) if port else "?", name(own[0]) if own else "?")

    live, cur, top, at_top = {}, 0, 0, {}
    for ev in snap["device_traces"][torch.device(dev).index or 0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], ev.get("frames", []))
            cur += ev["size"]
            if cur > top:
                top, at_top = cur, dict(live)
        elif ev["action"] in ("free_requested", "free_completed") and ev["addr"] in live:
            cur -= live.pop(ev["addr"])[0]
    by_line = {}
    for size, frames in at_top.values():
        site, step_line = where(frames)
        entry = by_line.setdefault((step_line, site), [0, 0])
        entry[0] += size
        entry[1] += 1
    blocks = sorted(by_line.items(), key=lambda kv: -kv[1][0])
    return {"peak_allocated_bytes": peak, "trace_peak_bytes": top,
            "live_at_peak": [{"step_line": k[0], "allocated_at": k[1], "bytes": v[0], "blocks": v[1]}
                             for k, v in blocks[:20]],
            "live_at_peak_other_bytes": sum(v[0] for _, v in blocks[20:])}


def memory(kzg, smi: str, dev) -> dict:
    """The --memory measurements (see the module docstring)."""
    from dataclasses import replace

    import torch

    import chip_smoke
    from kateth_tpu_torch.curves import msm
    from kateth_tpu_torch.kzg import Kzg

    case = chip_smoke.parse_vector(os.path.join(
        chip_smoke.VECTORS, "compute_blob_kzg_proof", "valid_0", "data.yaml"))
    blob, comm, proof = case["input"]["blob"], case["input"]["commitment"], case["output"]
    blobs, comms = [blob] * 64, [comm] * 64
    windowed = chip_smoke.eager_twin(Kzg(replace(kzg.setup, config=replace(kzg.config, comb_h=0))))
    comb_twin = chip_smoke.eager_twin(kzg)

    def peak(fn, want):
        if fn() != want:  # warm-up: kernels built, constants on the device
            raise AssertionError("profile_torch_commit: a wrong result")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base, base_reserved = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        got = fn()
        torch.cuda.synchronize()
        if got != want:
            raise AssertionError("profile_torch_commit: a wrong result")
        return {"peak_allocated_bytes": torch.cuda.max_memory_allocated(dev) - base,
                "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev) - base_reserved}

    out = {"device": smi,
           "eager_windowed_commit_64": peak(lambda: windowed.blobs_to_kzg_commitments(blobs),
                                            [comm] * 64),
           "eager_windowed_blob_proofs_64": peak(
               lambda: windowed.compute_blob_kzg_proofs(blobs, comms), [proof] * 64),
           "eager_comb_commit_64": peak(lambda: comb_twin.blobs_to_kzg_commitments(blobs),
                                        [comm] * 64)}
    c = kzg.config.msm_window
    elements, _ = windowed._decode_blobs(blobs)
    points = msm.pad_points(kzg.setup.g1_points)
    acc, digits = msm.window_start(elements, points[0].shape[0], c)
    out["eager_window_step_64"] = window_step_snapshot(points, acc, digits[0], c, dev)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--memory", action="store_true",
                        help="eager peaks and a window step's memory snapshot instead of times")
    args = parser.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from kateth_tpu_torch.curves import comb, compress, cuda_msm, msm, ops
    from kateth_tpu_torch.kzg import Kzg, protocol
    from kateth_tpu_torch.kzg.setup import DEFAULT_TRUSTED_SETUP

    if not torch.cuda.is_available():
        print("profile_torch_commit: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    F1 = ops.FP_FIELD
    dev = torch.device("cuda")
    kzg = Kzg.load_json(DEFAULT_TRUSTED_SETUP, device=dev)
    if args.memory:
        print(json.dumps(memory(kzg, smi, dev), indent=1))
        return 0
    cfg = kzg.config
    case = chip_smoke.parse_vector(os.path.join(
        chip_smoke.VECTORS, "blob_to_kzg_commitment", "valid_0", "data.yaml"))
    blobs = [case["input"]["blob"]] * 64

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    out = {"device": smi}

    # 1. the comb
    torch.cuda.reset_peak_memory_stats(dev)
    table, build_ms = timed(lambda: comb.build_table(kzg.setup.g1_points, cfg.comb_h))
    out["comb_table"] = {"build_s": build_ms / 1e3,
                         "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                         "rows": table[0].shape[0]}
    kzg._comb_table = table
    elements, ok = kzg._decode_blobs(blobs)
    want = comb.commit(table, elements, cfg.comb_h, cfg.n)

    h, n = cfg.comb_h, cfg.n
    d = comb.comb_dims(h)
    cols = comb.column_digits(elements, h, d).contiguous()  # (d, 64, n)
    idx = cols + (torch.arange(n, device=dev) << h)
    ms = {}
    (x, y, fl), ms["gather"] = timed(lambda: (table[0][idx], table[1][idx], cols != 0))
    chains, ms["comb_chain_sum"] = timed(lambda: cuda_msm.comb_chain_sum(x, y, fl))
    sums, ms["halving_sum"] = timed(lambda: msm.halving_sum(F1, chains, axis=2))

    def combine():
        acc = ops.identity(F1, (64,), dev)
        for t in range(d - 1, -1, -1):
            acc = ops.padd(F1, ops.pdouble(F1, acc), tuple(c[t] for c in sums))
        return acc

    acc, ms["double_add"] = timed(combine)
    assert all(torch.equal(a, b) for a, b in zip(acc, want)), "comb replay differs"
    out["comb_commit_ms_by_stage"] = ms

    (elements, ok), decode_ms = timed(lambda: kzg._decode_blobs(blobs))
    pt, commit_ms = timed(lambda: protocol.commit_comb(table, elements, cfg.comb_h, cfg.n))
    got, compress_ms = timed(lambda: compress.points_to_bytes(pt))
    assert got == [case["output"]] * 64
    z = protocol.fr_to_mont(protocol.fr_planes([12345] * 64, dev))
    em, lift_ms = timed(lambda: protocol.fr_to_mont(elements))
    y, eval_ms = timed(lambda: protocol.evaluate(em, z, kzg.setup.roots))
    _, quot_ms = timed(lambda: protocol.quotient(em, z, y, kzg.setup.roots, kzg.setup.inv_roots))
    out["blobs_to_kzg_commitments_ms"] = {
        "decode": decode_ms, "commit": commit_ms, "compress_and_read": compress_ms}
    out["prove_ms"] = {"to_mont": lift_ms, "evaluate": eval_ms, "quotient": quot_ms}

    # 2. the windowed Pippenger
    c = cfg.msm_window
    B = 1 << c
    pts = kzg.setup.g1_points
    want = msm.msm(pts, elements, c)
    digits = msm.window_digits(elements, c)
    acc = ops.identity(F1, (64,), dev)
    ms = dict.fromkeys(("argsort_gather", "prefix_scan_K7", "scan_rest", "boundary",
                        "halving_sum", "total_times_255", "combine"), 0.0)
    j = torch.arange(1, B, device=dev).expand(64, B - 1).contiguous()
    for w in range(digits.shape[0] - 1, -1, -1):
        dig = digits[w]

        def sort_gather():
            order = torch.argsort(dig, dim=-1, stable=True)
            return torch.take_along_dim(dig, order, dim=-1), tuple(a[order] for a in pts)

        (sd, gathered), dt = timed(sort_gather)
        ms["argsort_gather"] += dt
        _, dt = timed(lambda: cuda_msm.chain_prefix(gathered, cuda_msm.CHAIN))
        ms["prefix_scan_K7"] += dt

        def boundary_indices():
            c_j = torch.searchsorted(sd.contiguous(), j)
            last = torch.full_like(c_j[..., :1], sd.shape[-1] - 1)
            return c_j, torch.cat([(c_j - 1).clamp(min=0), last], dim=-1)

        (c_j, idx), dt = timed(boundary_indices)
        ms["boundary"] += dt
        prefix, dt = timed(lambda: cuda_msm.prefix_scan_kernel(gathered, idx))
        ms["scan_rest"] += dt  # one K7 launch included, taken out below
        bnd, dt = timed(lambda: ops.pselect(F1, c_j == 0, ops.identity(F1, (64, B - 1), dev),
                                            tuple(a[..., :-1, :] for a in prefix)))
        ms["boundary"] += dt
        gsum, dt = timed(lambda: msm.halving_sum(F1, bnd, axis=-2))
        ms["halving_sum"] += dt
        tot, dt = timed(lambda: msm.scalar_mul_const(F1, tuple(a[..., -1, :] for a in prefix), B - 1))
        ms["total_times_255"] += dt

        def combine():  # the window sum, then c doublings and the addition
            a = acc
            for _ in range(c):
                a = ops.pdouble(F1, a)
            return ops.padd(F1, a, ops.padd(F1, tot, ops.pneg(F1, gsum)))

        acc, dt = timed(combine)
        ms["combine"] += dt
    ms["scan_rest"] -= ms["prefix_scan_K7"]  # prefix_scan_kernel includes one K7 launch
    assert all(torch.equal(a, b) for a, b in zip(acc, want)), "msm replay differs"
    out["msm_commit_ms_by_stage"] = ms

    # 3. one traced comb commit
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, traced_ms = timed(lambda: protocol.commit_comb(table, elements, cfg.comb_h, cfg.n))
    busy_ms, launches = 0.0, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy_ms += ev.time_range.elapsed_us() / 1e3
            launches += 1
    out["traced_comb_commit"] = {"ms": traced_ms, "device_busy_ms": busy_ms,
                                 "device_busy_share": busy_ms / traced_ms,
                                 "device_operations": launches}

    # 4. device time by stage of one eager commit, each stage alone under
    # torch.profiler (its kernels' summed durations: the device work a
    # replay of the library's commit graph runs), and one traced library
    # commit after a warm-up (a graph replay where the tree has one)
    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            result = fn()
            torch.cuda.synchronize()
        evs = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
        return result, {"ms": sum(evs), "operations": len(evs)}

    rows = protocol.to_device([np.frombuffer(b"".join(blobs), dtype=np.uint8).reshape(64, -1)], dev)[0]
    stages = {}
    (el, _), stages["decode"] = device_ms(lambda: protocol.decode_blobs(rows))

    def columns_and_gather():
        cols = comb.column_digits(el, h, d).contiguous()
        idx = cols + (torch.arange(n, device=dev) << h)
        return table[0][idx], table[1][idx], cols != 0

    (x, y, fl), stages["columns_and_gather"] = device_ms(columns_and_gather)
    chains, stages["comb_chain_sum"] = device_ms(lambda: cuda_msm.comb_chain_sum(x, y, fl))
    sums, stages["halving_sum"] = device_ms(lambda: msm.halving_sum(F1, chains, axis=2))
    def double_add():
        a = ops.identity(F1, (64,), dev)
        for t in range(d - 1, -1, -1):
            a = ops.padd(F1, ops.pdouble(F1, a), tuple(c[t] for c in sums))
        return a

    acc, stages["double_add"] = device_ms(double_add)
    got, stages["compress"] = device_ms(lambda: compress.g1_compress_planes(acc))
    assert compress.rows_to_bytes(got.cpu().numpy()) == [case["output"]] * 64
    assert kzg.blobs_to_kzg_commitments(blobs) == [case["output"]] * 64  # the capture, if any
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, library_ms = timed(lambda: kzg.blobs_to_kzg_commitments(blobs))
    busy = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    out["commit_device_ms_by_stage"] = {"stages": stages,
                                        "sum_ms": sum(v["ms"] for v in stages.values()),
                                        "library_traced_ms": library_ms,
                                        "library_device_busy_ms": sum(busy),
                                        "library_device_operations": len(busy)}

    # 5. device time by stage of the windowed commit (comb_h = 0): the
    # head, every window step's stages, the tail; then a traced library
    # windowed commit
    from dataclasses import replace

    kzg_w = Kzg(replace(kzg.setup, config=replace(cfg, comb_h=0)))
    pts = kzg_w.setup.g1_points
    stages = {}

    def add(name, part):
        s = stages.setdefault(name, {"ms": 0.0, "operations": 0})
        s["ms"] += part["ms"]
        s["operations"] += part["operations"]

    def head():
        el, _ = protocol.decode_blobs(rows)
        return msm.window_start(el, pts[0].shape[0], c)

    (acc, digits), part = device_ms(head)
    add("head", part)
    for dig in digits:
        def doublings():
            a = acc
            for _ in range(c):
                a = ops.pdouble(F1, a)
            return a

        doubled, part = device_ms(doublings)
        add("doublings", part)

        def sort_gather():
            order = torch.argsort(dig, dim=-1, stable=True)
            return torch.take_along_dim(dig, order, dim=-1), tuple(a[order] for a in pts)

        (sd, gathered), part = device_ms(sort_gather)
        add("argsort_gather", part)
        # cuda_msm.prefix_scan_kernel at the boundaries by its stages: K7
        # within the chains, the Hillis-Steele scan of the chain totals, the
        # offset add on the 2^c gathered lanes a row
        g = cuda_msm.CHAIN
        within, part = device_ms(lambda: cuda_msm.chain_prefix(gathered, g))
        add("prefix_scan_K7", part)

        def totals_scan():
            totals = tuple(cuda_msm._chains(w, g)[..., g - 1, :] for w in within)
            incl = msm.prefix_scan(F1, totals, axis=-2)
            return tuple(torch.cat([i.expand(*t.shape[:-2], 1, t.shape[-1]), t[..., :-1, :]], dim=-2)
                         for i, t in zip(ops.identity(F1, (), dev), incl))

        excl, part = device_ms(totals_scan)
        add("chain_totals_scan", part)

        def boundary_indices():
            c_j = torch.searchsorted(sd.contiguous(), j)
            last = torch.full_like(c_j[..., :1], sd.shape[-1] - 1)
            return c_j, torch.cat([(c_j - 1).clamp(min=0), last], dim=-1)[..., None]

        (c_j, lane), part = device_ms(boundary_indices)
        add("boundary", part)

        def offset_add():
            return ops.padd(F1, tuple(torch.take_along_dim(w, lane, dim=-2) for w in within),
                            tuple(torch.take_along_dim(e, lane // g, dim=-2) for e in excl))

        prefix, part = device_ms(offset_add)
        add("offset_add", part)
        bnd, part = device_ms(lambda: ops.pselect(F1, c_j == 0, ops.identity(F1, (64, B - 1), dev),
                                                  tuple(a[..., :-1, :] for a in prefix)))
        add("boundary", part)
        gsum, part = device_ms(lambda: msm.halving_sum(F1, bnd, axis=-2))
        add("halving_sum", part)
        tot, part = device_ms(lambda: msm.scalar_mul_const(F1, tuple(a[..., -1, :] for a in prefix), B - 1))
        add("total_times_255", part)
        acc, part = device_ms(lambda: ops.padd(F1, doubled, ops.padd(F1, tot, ops.pneg(F1, gsum))))
        add("window_sum_and_add", part)
    got, part = device_ms(lambda: compress.g1_compress_planes(acc))
    add("tail", part)
    want = [case["output"]] * 64
    assert compress.rows_to_bytes(got.cpu().numpy()) == want, "windowed replay differs"
    assert kzg_w.blobs_to_kzg_commitments(blobs) == want  # the captures, if any
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, library_ms = timed(lambda: kzg_w.blobs_to_kzg_commitments(blobs))
    busy = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    out["msm_commit_device_ms_by_stage"] = {"stages": stages,
                                            "sum_ms": sum(v["ms"] for v in stages.values()),
                                            "library_traced_ms": library_ms,
                                            "library_device_busy_ms": sum(busy),
                                            "library_device_operations": len(busy)}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
