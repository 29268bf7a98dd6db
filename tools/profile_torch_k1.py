#!/usr/bin/env python3
"""Where the time of a K1 (mont_mul) call goes, on one GPU.

Most K1 launches come from the plain point formulas, a few hundred lanes
each, where a call's host time is most of its cost.  This script times,
at 128 Fp lanes, 1,000 calls of the whole call (limbs.mont_mul, as the
point formulas call it) and 1,000 calls of each piece a kernel wrapper's
host path may take, with time.perf_counter and no synchronisation inside
a loop: the routes the wrapper takes and the dearer ones it can avoid
(broadcasting equal shapes, a Stream object a call, binding the launcher a
call, an import a call), and the current-device check that each launch
makes before it selects the operands' device.  An empty loop's time is
subtracted from each piece.  It also times a call between CUDA events (median of 50) and the
kernel's device time per launch from torch.profiler at 128 and 8,192 Fp
lanes and 262,144 Fr lanes.  Prints one JSON object.

  python3 tools/profile_torch_k1.py [--tree PATH] [--calls 1000]

--tree imports kateth_tpu_torch from another checkout (another commit's
tree, unpacked), so that two versions can be compared in one run.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def per_call_us(fn, calls: int) -> float:
    """Microseconds of host time per call of fn() over `calls` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT, help="checkout to import kateth_tpu_torch from")
    ap.add_argument("--calls", type=int, default=1000)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    sys.path.insert(1, ROOT)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_k1: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from kateth_tpu_torch import cuda_lib
    from kateth_tpu_torch.fields import cuda_mont
    from kateth_tpu_torch.fields import limbs as L
    from kateth_tpu_torch.fields.specs import FP, FR

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)

    def elems(spec, lanes):
        d = rng.integers(0, 1 << 16, (lanes, spec.n_digits), dtype=np.int64)
        d[:, -1] = rng.integers(0, int(spec.mod_digits[-1]), lanes)
        return torch.as_tensor(d).to(dev)

    lanes = 128
    a, b = elems(FP, lanes), elems(FP, lanes)
    out = torch.empty_like(a)
    index = a.get_device()
    lib_name, fn_name, _ = cuda_lib.KERNELS["mont_mul"]
    launcher = getattr(cuda_lib.library(lib_name), fn_name)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def import_in_function():
        from kateth_tpu_torch.fields import cuda_mont  # noqa: F401

    def check_by_device_objects(*tensors):
        """An operand check that builds torch.device objects."""
        d = tensors[0].device
        for t in tensors:
            if t.device != d or t.device.type != "cuda":
                raise ValueError
            if t.dtype != torch.int64 or not t.is_contiguous():
                raise ValueError

    pieces = {
        "loop": lambda: None,
        "limbs.mont_mul (the whole call)": lambda: L.mont_mul(FP, a, b),
        "cuda_mont.mont_mul": lambda: cuda_mont.mont_mul(FP, a, b),
        "import cuda_mont in a function": import_in_function,
        "a.device.type": lambda: a.device.type,
        "a.is_cpu": lambda: a.is_cpu,
        "torch.broadcast_shapes": lambda: torch.broadcast_shapes(a.shape, b.shape),
        "a.shape != b.shape": lambda: a.shape != b.shape,
        "a.expand(shape).contiguous()": lambda: a.expand(a.shape).contiguous(),
        "a.contiguous()": lambda: a.contiguous(),
        "torch.empty(shape, dtype, device)": lambda: torch.empty(a.shape, dtype=torch.int64,
                                                                 device=a.device),
        "torch.empty_like(a)": lambda: torch.empty_like(a),
        "operand check with device objects, 3 tensors": lambda: check_by_device_objects(a, b, out),
        "cuda_lib.check_cuda, 3 tensors": lambda: cuda_lib.check_cuda(a, b, out),
        "library() and KERNELS lookup": lambda: getattr(cuda_lib.library(lib_name),
                                                        cuda_lib.KERNELS["mont_mul"][1]),
        "torch.cuda.current_stream(device).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "data_ptr() x 3": lambda: (a.data_ptr(), b.data_ptr(), out.data_ptr()),
        "math.prod(shape[:-1])": lambda: math.prod(a.shape[:-1]),
        "ctypes launch (bound launcher, stream given)":
            lambda: launcher(1, a.data_ptr(), b.data_ptr(), out.data_ptr(), lanes, stream),
        "count_mont_mul_lanes": lambda: cuda_lib.count_mont_mul_lanes(lanes),
    }
    if hasattr(torch._C, "_cuda_getDevice"):
        pieces["torch._C._cuda_getDevice() (the launch's device check)"] = torch._C._cuda_getDevice
    pieces["torch.cuda.current_device()"] = torch.cuda.current_device
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):
        pieces["torch._C._cuda_getCurrentRawStream(index)"] = (
            lambda: torch._C._cuda_getCurrentRawStream(index))
    host_us = {name: per_call_us(fn, args.calls) for name, fn in pieces.items()}
    loop = host_us.pop("loop")
    host_us = {name: v - loop for name, v in host_us.items()}

    device = {}
    for spec, n in ((FP, 128), (FP, 8192), (FR, 262144)):
        x, y = elems(spec, n), elems(spec, n)
        call = lambda: cuda_mont.mont_mul(spec, x, y)  # noqa: E731
        device[f"{spec.name} {n}"] = {
            "call_ms": chip_smoke.cuda_time_ms(call, 50),
            "device_ms": chip_smoke.device_ms_per_call(call, 100, "mont_mul_kernel"),
        }
    print(json.dumps({"tree": os.path.abspath(args.tree), "device": smi, "loop_us": loop,
                      "host_us_per_call": host_us, "k1": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
