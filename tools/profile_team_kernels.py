#!/usr/bin/env python3
"""Where the team kernels K3 (G1 ladder) and K4 (Miller loop) spend their
time, on one GPU.

Builds kernels.cu and miller.cu from a copy of kateth_tpu_torch/csrc in
five variants, which skip nothing, the product rounds, the linear rounds,
both, or the small multiples (the schedules' SMALL instructions), and
times each with CUDA events: K3 at the verify's 321 lanes, K4 at its 2
lanes.  A skipping variant computes wrong values, so nothing is checked;
the full kernels are checked by chip_smoke.py.  The differences give the
time of each kind of round.  Prints one JSON object.

Run from the repository root: python3 tools/profile_team_kernels.py
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: variant -> what it skips (bits: 1 products, 2 linear rounds, 4 SMALL)
VARIANTS = {0: "nothing", 1: "products", 2: "linear rounds", 3: "both", 4: "small multiples"}
PATCHES = [
    ("team_mul(slot, S::instr(i));", "{ if (!(KT_SKIP & 1)) team_mul(slot, S::instr(i)); }"),
    ("team_linear(slot, S::instr(i), bit);",
     "{ if (!(KT_SKIP & 2)) team_linear(slot, S::instr(i), bit); }"),
    ("fp_small_cc(x, x, b);", "if (!(KT_SKIP & 4)) fp_small_cc(x, x, b);"),
]


def build(out: str) -> None:
    """One nvcc per (variant, source), all at once, into `out`."""
    from kateth_tpu_torch import cuda_lib

    src = os.path.join(out, "csrc")
    shutil.copytree(cuda_lib.CSRC, src)
    path = os.path.join(src, "team.cuh")
    text = open(path).read()
    for old, new in PATCHES:
        if old not in text:
            raise RuntimeError(f"team.cuh has no {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    procs = []
    for v in VARIANTS:
        for name in ("kernels", "miller"):
            cmd = [cuda_lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                   "-O3", "-shared", "-Xcompiler", "-fPIC", f"-DKT_SKIP={v}", "-I", src,
                   "-o", os.path.join(out, f"lib{name}{v}.so"), os.path.join(src, f"{name}.cu")]
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    for p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(log)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from kateth_tpu_torch import host
    from kateth_tpu_torch.curves import g1 as g1mod
    from kateth_tpu_torch.curves import g2 as g2mod
    from kateth_tpu_torch.curves import ops
    from kateth_tpu_torch.fields import limbs as L

    if not torch.cuda.is_available():
        print("profile_team_kernels: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = os.path.join(ROOT, "build", "profile_team_kernels")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    build(out)

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016)
    pts = [host.jac_mul_raw(host.FP_OPS, host.G1_GEN, int(k)) for k in rng.integers(1, 1 << 62, 64)]
    P = [torch.as_tensor(np.resize(c, (321, 24))).to(dev) for c in g1mod.from_ints(pts)]
    sc = torch.as_tensor(np.stack([
        L.int_to_digits(int.from_bytes(rng.bytes(32), "big") % host.R, 16) for _ in range(321)
    ])).to(dev)
    outs = [torch.empty_like(P[0]) for _ in range(3)]
    xp, yp = (c.contiguous() for c in ops.to_affine(ops.FP_FIELD, tuple(c[:2] for c in P)))
    q2 = [host.jac_mul_raw(host.FP2_OPS, host.G2_GEN, int(k)) for k in rng.integers(1, 1 << 62, 2)]
    xq, yq = (c.contiguous() for c in ops.to_affine(
        ops.FP2_FIELD, tuple(torch.as_tensor(c).to(dev) for c in g2mod.from_ints(q2))))
    f = torch.empty((2, 2, 3, 2, 24), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    V = ctypes.c_void_p
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "ms": {}}
    for v, skips in VARIANTS.items():
        k3 = ctypes.CDLL(os.path.join(out, f"libkernels{v}.so")).kateth_g1_ladder
        k3.argtypes = [V] * 7 + [ctypes.c_int64, V]
        k4 = ctypes.CDLL(os.path.join(out, f"libmiller{v}.so")).kateth_miller
        k4.argtypes = [V] * 5 + [ctypes.c_int64, V]
        ptrs3 = [t.data_ptr() for t in (*P, sc, *outs)]
        ptrs4 = [t.data_ptr() for t in (xp, yp, xq, yq, f)]
        if k3(*ptrs3, 321, stream) or k4(*ptrs4, 2, stream):
            raise RuntimeError(f"variant {v}: launch failed")
        result["ms"][f"skip {skips}"] = {
            "g1_ladder_321_lanes": chip_smoke.cuda_time_ms(lambda: k3(*ptrs3, 321, stream), 9),
            "miller_2_lanes": chip_smoke.cuda_time_ms(lambda: k4(*ptrs4, 2, stream), 9),
        }
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
