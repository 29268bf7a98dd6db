#!/usr/bin/env python3
"""Where a 64-blob batch verification spends its time in the PyTorch/CUDA
port, on one GPU.

Loads the mainnet setup, builds one 64-blob batch from the vendored
`valid_true_4` vector, warms up, then
  1. times the three stages on the host clock, each ending in a sync:
     the host prefix (`_verify_batch_stage`), the fused program
     (`verify_blob_batch_fused`) and the pairing check;
  2. traces one whole `verify_blob_kzg_proof_batch` with torch.profiler
     and reports the device busy share (summed kernel time over the wall
     time of the traced call) and the device time by kernel.
Prints one JSON object; writes the Chrome trace to chiprun_out/.

Run from the repository root: python3 tools/profile_torch_verify.py
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from kateth_tpu_torch.kzg import Kzg, protocol
    from kateth_tpu_torch.kzg.setup import DEFAULT_TRUSTED_SETUP

    if not torch.cuda.is_available():
        print("profile_torch_verify: no CUDA device", file=sys.stderr)
        return 1
    kzg = Kzg.load_json(DEFAULT_TRUSTED_SETUP)
    case = chip_smoke.parse_vector(os.path.join(
        chip_smoke.VECTORS, "verify_blob_kzg_proof_batch", "valid_true_4", "data.yaml"))
    batch = tuple(case["input"][k] * 16 for k in ("blobs", "commitments", "proofs"))
    assert kzg.verify_blob_kzg_proof_batch(*batch) is True  # warm-up

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    (n, args), stage_ms = timed(lambda: kzg._verify_batch_stage(*batch))
    (pc_in, _), fused_ms = timed(lambda: protocol.verify_blob_batch_fused(*args))
    _, pairing_ms = timed(lambda: protocol.pairing_check(*pc_in))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, traced_ms = timed(lambda: kzg.verify_blob_kzg_proof_batch(*batch))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    prof.export_chrome_trace(os.path.join(ROOT, "chiprun_out", "verify_batch_trace.json"))

    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(ev.name, [0, 0.0])
            k[0] += 1
            k[1] += ev.time_range.elapsed_us() / 1e3
    busy_ms = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "stage_ms": {"host_prefix": stage_ms, "fused": fused_ms, "pairing_check": pairing_ms},
        "traced_batch_ms": traced_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / traced_ms,
        "device_launches": sum(v[0] for v in kernels.values()),
        "top_kernels_ms": {name[:80]: {"calls": c, "ms": ms} for name, (c, ms) in top},
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
