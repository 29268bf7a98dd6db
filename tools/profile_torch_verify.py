#!/usr/bin/env python3
"""Where a 64-blob batch verification spends its time in the PyTorch/CUDA
port, on one GPU, and what the paths that share its field arithmetic take.

Loads the mainnet setup, builds one 64-blob batch from the vendored
`valid_true_4` vector, warms up (the first batch of a size captures its
CUDA graph where the tree has one), then
  1. times the three stages of the eager program on the host clock, each
     ending in a sync: the host prefix (`_verify_batch_stage`), the fused
     program (`verify_blob_batch_fused`) and the pairing check;
  2. counts the host syncs of one `_verify_batch_dispatch` (PyTorch's sync
     debug mode, "warn", one warning a sync) and shows where the first one
     happens (mode "error");
  3. traces one whole `verify_blob_kzg_proof_batch` (the library's path:
     a graph replay where the tree has graphs) and one eager batch (stage,
     fused program, pairing check, read-back) with torch.profiler: the
     device operations, the device busy time and its share of the traced
     wall time, and the device time by kernel;
  4. times streaming through `verify_blob_kzg_proof_batches`, 8 batches of
     64 blobs, `--reps` times (proofs/s: median, min, max);
  5. times the other paths that share the field arithmetic: a
     single-point `verify_kzg_proof` (median of 20 after a warm-up), a
     64-blob `blobs_to_kzg_commitments` on the comb (the table build and
     the first commit apart; median of --reps), a 64-blob
     `compute_blob_kzg_proofs` (median of --reps after a warm-up) and the
     device decode of the setup's 65 G2 points (`decompress.g2_decompress`,
     eager in every tree; median of 3 after a warm-up).  The first three
     are graph replays where the tree captures them, eager calls where it
     does not; then, on a second Kzg at comb_h = 0, a 64-blob windowed
     `blobs_to_kzg_commitments` and `compute_blob_kzg_proofs` (median of
     --reps after the first call, which captures), and the bytes that Kzg's
     captures newly reserved for its graph pool;
  6. times one call of `limbs.add`, `limbs.sub` and `limbs.mont_mul` (K1)
     on (65, 2, 24) Fp planes, the G2 decode's shape, over 2,000
     unsynchronised calls after 100: the host cost of a plain operation
     against a kernel wrapper's.
Prints one JSON object with the card's name and power limit.

With --count-ops it needs no card: it counts, on the CPU, the tensor
operations of one 64-blob mainnet batch program
(`protocol.verify_blob_batch_fused` and `pairing_check` on random bytes:
the program has no data-dependent branch, so the operations do not depend
on the values) under a TorchDispatchMode, by the outermost
`fields/limbs.py` function on the Python stack, else the innermost port
function; every operation that is not a view counts (on a CUDA device each
launches at least one device operation), and so does every read of a
tensor's value on the host (`aten._local_scalar_dense`, a sync on a CUDA
device).  Each kernel wrapper (K1-K5) counts as one operation: its plain
version runs uncounted, and K2-K5's are replaced by fresh zero tensors of
their output shapes, which leaves the operations around them the same and
saves the plain versions' minutes.  A warm-up run first puts every cached
constant in place.  About a minute.

  python3 tools/profile_torch_verify.py [--tree PATH] [--reps 5] [--count-ops]

--tree imports kateth_tpu_torch from another checkout (another commit's
tree, unpacked), so that two versions can be compared in one run.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def count_ops(tree: str) -> dict:
    """The operation count of --count-ops (module docstring), on the CPU."""
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from kateth_tpu_torch import cuda_pairing
    from kateth_tpu_torch.fields import cuda_mont
    from kateth_tpu_torch.fields.specs import FP, FR
    from kateth_tpu_torch.kzg import protocol

    aten = torch.ops.aten
    views = {aten.slice, aten.select, aten.unsqueeze, aten.view, aten.expand, aten.alias,
             aten.detach, aten.reshape, aten._unsafe_view, aten.squeeze, aten.permute,
             aten.transpose, aten.t, aten.unbind, aten.split, aten.lift_fresh}
    paused = [0]
    ops, host_reads, kernels = collections.Counter(), collections.Counter(), collections.Counter()

    def where() -> str:
        frames = [f for f in traceback.extract_stack() if "kateth_tpu_torch" + os.sep in f.filename]
        limbs = [f for f in frames if f.filename.endswith(os.path.join("fields", "limbs.py"))]
        f = limbs[0] if limbs else frames[-1] if frames else None
        return "?" if f is None else f"{os.path.relpath(f.filename, tree)}:{f.name}"

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not paused[0]:
                if func.overloadpacket is aten._local_scalar_dense:
                    host_reads[where()] += 1
                elif func.overloadpacket not in views:
                    ops[where()] += 1
            return func(*args, **(kwargs or {}))

    def one_op(name, fn):
        def wrapper(*a, **k):
            kernels[name] += 1
            paused[0] += 1
            try:
                return fn(*a, **k)
            finally:
                paused[0] -= 1
        return wrapper

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int64)

    def ladder(point, scalars):
        batch = torch.broadcast_shapes(scalars.shape[:-1], *(c.shape[:-1] for c in point))
        return tuple(zeros(*batch, FP.n_digits) for _ in point)

    stand_ins = {
        (cuda_mont, "mont_mul"): one_op("mont_mul", cuda_mont.mont_mul),
        (cuda_mont, "pow_const"): one_op("pow_const", lambda spec, a, e: torch.zeros_like(a)),
        (cuda_mont, "g1_scalar_mul"): one_op("g1_ladder", ladder),
        (cuda_pairing, "miller_loop_affine"): one_op(
            "miller", lambda xp, yp, xq, yq: zeros(*xp.shape[:-1], 2, 3, 2, FP.n_digits)),
        (cuda_pairing, "hard_part"): one_op("hard_part", torch.zeros_like),
    }
    for (mod, name), fn in stand_ins.items():
        setattr(mod, name, fn)

    rng = np.random.default_rng(1)
    B, n = 64, 4096
    blob = rng.integers(0, 256, (B, n, 32), dtype=np.uint8)
    blob[..., 0] &= 0x1F  # below r
    points = rng.integers(0, 256, (2, B, 48), dtype=np.uint8)
    points[..., 0] = (points[..., 0] & 0x1F) | 0x80  # compressed, below p
    planes = rng.integers(0, 1 << 16, (3, B, FR.n_digits), dtype=np.int64)
    planes[..., -1] &= 0x3FFF
    roots = rng.integers(0, 1 << 16, (n, FR.n_digits), dtype=np.int64)
    roots[..., -1] &= 0x3FFF
    tau2 = rng.integers(0, 1 << 16, (3, 2, FP.n_digits), dtype=np.int64)
    tau2[..., -1] &= 0xFFF
    inputs = ([torch.as_tensor(blob.reshape(B, n * 32)), torch.as_tensor(points[0]),
               torch.as_tensor(points[1])] + [torch.as_tensor(p) for p in planes]
              + [torch.as_tensor(roots), tuple(torch.as_tensor(t) for t in tau2)])

    def program():
        pc_in, packed = protocol.verify_blob_batch_fused(*inputs)
        return protocol.pairing_check(*pc_in), packed

    torch.set_num_threads(min(4, torch.get_num_threads()))
    program()
    ops.clear(), host_reads.clear(), kernels.clear()
    with Count():
        program()
    return {
        "tree": tree, "n": n, "batch": B,
        "operations": sum(ops.values()) + sum(kernels.values()),
        "plain_operations": sum(ops.values()),
        "kernel_calls": dict(kernels),
        "host_reads": sum(host_reads.values()),
        "by_function": dict(ops.most_common()),
        "host_reads_by_function": dict(host_reads.most_common()),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT, help="checkout to import kateth_tpu_torch from")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--count-ops", action="store_true",
                    help="count the batch program's operations on the CPU instead")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    sys.path.insert(1, ROOT)
    if args.count_ops:
        print(json.dumps(count_ops(tree), indent=1))
        return 0

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from kateth_tpu_torch.curves import decompress
    from kateth_tpu_torch.kzg import Kzg, protocol
    from kateth_tpu_torch.kzg.setup import DEFAULT_TRUSTED_SETUP

    if not torch.cuda.is_available():
        print("profile_torch_verify: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kzg = Kzg.load_json(DEFAULT_TRUSTED_SETUP)
    case = chip_smoke.parse_vector(os.path.join(
        chip_smoke.VECTORS, "verify_blob_kzg_proof_batch", "valid_true_4", "data.yaml"))
    batch = tuple(case["input"][k] * 16 for k in ("blobs", "commitments", "proofs"))
    assert kzg.verify_blob_kzg_proof_batch(*batch) is True  # warm-up, and the capture
    assert kzg.verify_blob_kzg_proof_batch(*batch) is True

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    (n, staged), stage_ms = timed(lambda: kzg._verify_batch_stage(*batch))
    (pc_in, _), fused_ms = timed(lambda: protocol.verify_blob_batch_fused(*staged))
    _, pairing_ms = timed(lambda: protocol.pairing_check(*pc_in))

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pending = kzg._verify_batch_dispatch(*batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # every warning but the mode's own note that it is a prototype counts as
    # a sync; each names the Python line that called the syncing operation
    sync_warnings = [f"{os.path.relpath(w.filename, tree)}:{w.lineno}: {w.message}"
                     for w in caught if "prototype feature" not in str(w.message)]
    assert kzg._verify_batch_finalize(pending) is True
    first_sync = None  # where the first sync of a dispatch happens
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = kzg._verify_batch_dispatch(*batch)
    except RuntimeError:
        first_sync = traceback.format_exc().splitlines()[-12:]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    def eager_batch():
        n, staged = kzg._verify_batch_stage(*batch)
        pc_in, packed = protocol.verify_blob_batch_fused(*staged)
        return kzg._verify_batch_finalize((n, protocol.pairing_check(*pc_in)[0], packed))

    traces = {}
    for name, fn in (("library", lambda: kzg.verify_blob_kzg_proof_batch(*batch)),
                     ("eager", eager_batch)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            verdict, wall_ms = timed(fn)
        assert verdict is True
        kernels = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                k = kernels.setdefault(ev.name, [0, 0.0])
                k[0] += 1
                k[1] += ev.time_range.elapsed_us() / 1e3
        busy_ms = sum(v[1] for v in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
        traces[name] = {
            "traced_batch_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "device_operations": sum(v[0] for v in kernels.values()),
            "top_kernels_ms": {k[:60]: {"calls": c, "ms": ms} for k, (c, ms) in top},
        }

    rates = []
    for _ in range(args.reps):
        verdicts, ms = timed(lambda: kzg.verify_blob_kzg_proof_batches([batch] * 8))
        assert verdicts == [True] * 8
        rates.append(8 * 64 / ms * 1e3)

    point_case = chip_smoke.parse_vector(os.path.join(
        chip_smoke.VECTORS, "verify_kzg_proof", "valid_true", "data.yaml"))["input"]
    point_args = tuple(point_case[k] for k in ("proof", "commitment", "z", "y"))
    single_ms = []
    for _ in range(21):
        verdict, ms = timed(lambda: kzg.verify_kzg_proof(*point_args))
        assert verdict is True
        single_ms.append(ms)

    blob_case = chip_smoke.parse_vector(os.path.join(
        chip_smoke.VECTORS, "blob_to_kzg_commitment", "valid_0", "data.yaml"))
    blobs = [blob_case["input"]["blob"]] * 64
    first, first_ms = timed(lambda: kzg.blobs_to_kzg_commitments(blobs[:1]))  # builds the table
    assert first == [blob_case["output"]]
    assert kzg.blobs_to_kzg_commitments(blobs) == [blob_case["output"]] * 64  # the capture
    commit_ms = []
    for _ in range(args.reps):
        out, ms = timed(lambda: kzg.blobs_to_kzg_commitments(blobs))
        assert out == [blob_case["output"]] * 64
        commit_ms.append(ms)

    proof_case = chip_smoke.parse_vector(os.path.join(
        chip_smoke.VECTORS, "compute_blob_kzg_proof", "valid_0", "data.yaml"))
    p_blobs = [proof_case["input"]["blob"]] * 64
    p_comms = [proof_case["input"]["commitment"]] * 64
    blob_proofs_ms = []
    for _ in range(args.reps + 1):
        out, ms = timed(lambda: kzg.compute_blob_kzg_proofs(p_blobs, p_comms))
        assert out == [proof_case["output"]] * 64
        blob_proofs_ms.append(ms)

    from dataclasses import replace

    kzg_w = Kzg(replace(kzg.setup, config=replace(kzg.config, comb_h=0)))
    windowed = {}
    for op, fn, want in (
            ("commit", lambda: kzg_w.blobs_to_kzg_commitments(p_blobs), p_comms),
            ("blob_proofs", lambda: kzg_w.compute_blob_kzg_proofs(p_blobs, p_comms),
             [proof_case["output"]] * 64)):
        runs = []
        for _ in range(args.reps + 1):  # the first call captures
            out, ms = timed(fn)
            assert out == want
            runs.append(ms)
        windowed[op] = {"median": statistics.median(runs[1:]), "runs": runs[1:],
                        "first_call_ms": runs[0]}
    cache = getattr(kzg_w, "_graphs", None)
    if cache is not None:
        captures = {id(g): g for graphs in cache.programs.values() for x in graphs.graphs.values()
                    for g in ((x.head, x.step, x.tail) if hasattr(x, "step") else (x,))}
        windowed["pool_reserved_bytes"] = sum(g.pool_reserved_bytes for g in captures.values())
    del kzg_w, cache

    with open(DEFAULT_TRUSTED_SETUP) as f:
        encs = [bytes.fromhex(h[2:]) for h in json.load(f)["g2_monomial"]]
    raw = torch.as_tensor(np.frombuffer(b"".join(encs), dtype=np.uint8).reshape(-1, 96).copy())
    raw = raw.to("cuda")
    g2_ms = []
    for _ in range(4):
        (_, enc, curve, sub), ms = timed(lambda: decompress.g2_decompress(raw))
        assert bool((enc & curve & sub).all())
        g2_ms.append(ms)

    from kateth_tpu_torch.fields import limbs as L
    from kateth_tpu_torch.fields.specs import FP

    gen = torch.Generator(device="cuda").manual_seed(5)
    a, b = (torch.randint(0, 1 << 16, (65, 2, 24), device="cuda", generator=gen) for _ in range(2))
    for x in (a, b):
        x[..., -1] %= int(FP.mod_digits[-1])  # below p
    call_us = {}
    for name, fn in (("add", L.add), ("sub", L.sub), ("mont_mul", L.mont_mul)):
        for _ in range(100):
            fn(FP, a, b)
        _, ms = timed(lambda: [fn(FP, a, b) for _ in range(2000)])
        call_us[name] = ms / 2000 * 1e3

    print(json.dumps({
        "tree": tree, "device": smi,
        "graphs": hasattr(kzg, "_verify_graphs"),
        "path_graphs": hasattr(kzg, "_graphs"),
        "stage_ms": {"host_prefix": stage_ms, "fused": fused_ms, "pairing_check": pairing_ms},
        "dispatch_host_syncs": len(sync_warnings),
        "dispatch_sync_warnings": sorted(set(sync_warnings)),
        "first_dispatch_sync": first_sync,
        "traced": traces,
        "streaming_proofs_per_s": {"median": statistics.median(rates), "min": min(rates),
                                   "max": max(rates), "runs": rates},
        "single_point_verify_ms": {"median": statistics.median(single_ms[1:]),
                                   "min": min(single_ms[1:]), "max": max(single_ms[1:])},
        "comb_commit_64_ms": {"median": statistics.median(commit_ms), "runs": commit_ms,
                              "first_commit_with_table_build_ms": first_ms},
        "blob_proofs_64_ms": {"median": statistics.median(blob_proofs_ms[1:]),
                              "runs": blob_proofs_ms[1:]},
        "windowed_64_ms": windowed,
        "g2_decode_65_ms": {"median": statistics.median(g2_ms[1:]), "runs": g2_ms[1:]},
        "fp2_plane_call_us": call_us,
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
