#!/usr/bin/env python3
"""The benchmark of kateth_tpu_torch: one run of one cell of BENCHMARK.json.

  python3 kzgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the checkout's root on a machine with the cards the cell asks
for.  Without them it exits 2 and prints no result.  The last line of
standard output is the result: correct, attempted, failed, metrics (the
cell's end-to-end metrics, or with --trace 1 its per-layer metrics),
device, with --trace 1 breakdown, and last the checks, each number
compared beside its limit, which also end standard error.  A run in
whose process jax, jaxlib, flax or kateth_tpu is loaded once the window
has closed exits 3 and prints no result."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "kateth_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of a build or a kernel at a fixed place in the checkout
    cache = os.path.join(ROOT, ".cache", "kzgbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)
    from kzgbench import harness, manifest

    chips = manifest.workload(manifest.load(ROOT), args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kzgbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from kzgbench.program import Port

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    limit = power_limit()
    log(f"card: {limit}")
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), Port, ROOT, log=log)
    loaded = forbidden_modules()
    if loaded:
        log(f"kzgbench: the run's process loaded {', '.join(loaded)}")
        return 3
    out["device"]["power_limit"] = limit
    for name, m in out["metrics"].items():
        log(f"{name}: {m['value']!r} {m['unit']}")
    log(f"correct: {out['correct']}")
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
