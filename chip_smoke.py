#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kateth_tpu_torch) on one NVIDIA GPU.

Phases, one line each; any failure exits non-zero before the last line:

1. device: the card's name and power limit (nvidia-smi); no CUDA -> fail.
2. build: compile the five CUDA kernels from kateth_tpu_torch/csrc.
3. kernels: each kernel at the verify path's shapes, held bit for bit
   against its plain PyTorch version on the same inputs on the card, with
   the median time of each (CUDA events, after a warm-up).
4. main path: Kzg.load_json of the mainnet setup on the card, then every
   vendored verify_blob_kzg_proof_batch and verify_blob_kzg_proof vector
   (true/false must match, `output: null` must raise KzgError), then a few
   64-blob batches through verify_blob_kzg_proof_batches (proofs/s, for
   information).  The launch counters are zeroed just before and read just
   after; every kernel must have launched.
5. the kernels JSON line, the nvidia-smi line, and the result line.

Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
VECTORS = os.path.join(ROOT, "tests", "vectors")

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and 32x32->64-bit
#: integer multiplies/s: 64 IMADs per SM per clock (half the 128 fp32 FMAs
#: behind the 67 TFLOP/s fp32 figure), two IMADs per wide product.
PEAK_BYTES_S = 3.35e12
PEAK_WIDE_MULS_S = 67e12 / 2 / 2 / 2

#: wide multiplies of one Montgomery product by CIOS with N limbs: 2N^2 + N
MULS_FR, MULS_FP = 2 * 8 * 8 + 8, 2 * 12 * 12 + 12


def log(msg: str) -> None:
    print(msg, flush=True)


def parse_vector(path: str) -> dict:
    """The fixed data.yaml layout of tests/vectors: `input:` with scalar
    or list fields of quoted hex strings, then `output:`."""
    inp, out, key = {}, None, None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("output:"):
                v = line.split(":", 1)[1].strip()
                out = {"true": True, "false": False, "null": None}[v]
            elif line.startswith("  - "):
                inp[key].append(bytes.fromhex(line[4:].strip("'")[2:]))
            elif line.startswith("  ") and ":" in line:
                key, v = (s.strip() for s in line.split(":", 1))
                if v in ("", "[]"):
                    inp[key] = []
                else:
                    inp[key] = bytes.fromhex(v.strip("'")[2:])
    return {"input": inp, "output": out}


def ptxas_summary(log_text: str) -> list[str]:
    """'kernel: R registers, S bytes stack' for each entry function in an
    nvcc -Xptxas -v log."""
    out, name = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            name = next(k for k in re.findall(r"[a-z0-9_]+_kernel", mangled))
            name = re.sub(r"^.*\d+(?=[a-z])", "", name)  # the length prefix
            name += "".join(f"<{f}>" for f in ("FrField", "FpField") if f in mangled)
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            stack = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {stack} bytes stack")
            name = None
    return out


def cuda_time_ms(fn, runs: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() between CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(int((g - w).abs().max()) for g, w in zip(got, want))


def kernel_phases(dev, smi: str) -> list[dict]:
    from kateth_tpu_torch import cuda_pairing, host
    from kateth_tpu_torch.curves import g1 as g1mod
    from kateth_tpu_torch.curves import g2 as g2mod
    from kateth_tpu_torch.curves import ops
    from kateth_tpu_torch.fields import cuda_mont, fp12
    from kateth_tpu_torch.fields import limbs as L
    from kateth_tpu_torch.fields.specs import FP, FR

    rng = np.random.default_rng(20261016)

    def field_elems(spec, lanes):
        """Random canonical digits, with lane 0 = N - 1 and lane 1 = 0."""
        d = rng.integers(0, 1 << 16, (lanes, spec.n_digits), dtype=np.int64)
        d[:, -1] = rng.integers(0, int(spec.mod_digits[-1]), lanes)
        d[0] = L.int_to_digits(spec.modulus - 1, spec.n_digits)
        d[1] = 0
        return torch.as_tensor(d).to(dev)

    out = []

    def record(name, src, replaces, kernel_fn, plain_fn, runs, plain_runs, nbytes, muls):
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version (max {err})")
        ms = cuda_time_ms(kernel_fn, runs)
        plain_ms = cuda_time_ms(plain_fn, plain_runs)
        bytes_ms = nbytes / PEAK_BYTES_S * 1e3
        ops_ms = muls / PEAK_WIDE_MULS_S * 1e3
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }
        log(f"kernel {name}: equal to plain; {ms:.4f} ms (plain {plain_ms:.2f} ms, "
            f"bound {entry['bound_ms']:.4f} ms by {entry['bound_by']}) [{smi}]")
        out.append(entry)
        return entry

    src = "kateth_tpu_torch/csrc/kernels.cu"
    # K1 at the evaluate shape: B x N = 64 x 4096 Fr lanes
    a, b = field_elems(FR, 64 * 4096), field_elems(FR, 64 * 4096).flip(0)
    record("mont_mul", src, "kateth_tpu/fields/pallas_mont.py:177",
           lambda: cuda_mont.mont_mul(FR, a, b), lambda: cuda_mont.mont_mul_plain(FR, a, b),
           20, 3, 3 * a.numel() * 8, a.shape[0] * MULS_FR)
    # K1 over Fp at the setup-load shape (4096 lanes): checked, logged
    a, b = field_elems(FP, 4096), field_elems(FP, 4096).flip(0)
    if max_abs_err(cuda_mont.mont_mul(FP, a, b), cuda_mont.mont_mul_plain(FP, a, b)):
        raise AssertionError("mont_mul over Fp differs from its plain version")
    log("kernel mont_mul (Fp, 4096 lanes): equal to plain")

    # K2: the G1 square root over the 2B = 128 decompression lanes, and p - 2
    a = field_elems(FP, 128)
    e_sqrt = (FP.modulus + 1) // 4
    sqr_mul = (e_sqrt.bit_length() - 1) + (bin(e_sqrt).count("1") - 1)
    record("pow_chain", src, "kateth_tpu/fields/pallas_mont.py:253",
           lambda: cuda_mont.pow_const(FP, a, e_sqrt),
           lambda: cuda_mont.pow_const_plain(FP, a, e_sqrt),
           10, 2, 2 * a.numel() * 8, 128 * sqr_mul * MULS_FP)
    e_inv = FP.modulus - 2
    if max_abs_err(cuda_mont.pow_const(FP, a, e_inv), cuda_mont.pow_const_plain(FP, a, e_inv)):
        raise AssertionError("pow_chain with p - 2 differs from its plain version")
    log("kernel pow_chain (p - 2, 128 lanes): equal to plain")

    # K3 at the fused verify shape: 5B + 1 = 321 lanes, 3B + 1 random
    # scalars and 2B subgroup lanes with scalar r
    pts = [host.jac_mul_raw(host.FP_OPS, host.G1_GEN, int(k))
           for k in rng.integers(1, 1 << 62, 64)]
    P = tuple(torch.as_tensor(np.resize(c, (321, 24))).to(dev) for c in g1mod.from_ints(pts))
    sc = np.stack([L.int_to_digits(int.from_bytes(rng.bytes(32), "big") % host.R, 16)
                   for _ in range(193)] + [L.int_to_digits(host.R, 16)] * 128)
    sc = torch.as_tensor(sc).to(dev)
    record("g1_ladder", src, "kateth_tpu/fields/pallas_mont.py:452",
           lambda: cuda_mont.g1_scalar_mul(P, sc),
           lambda: cuda_mont.g1_scalar_mul_plain(P, sc),
           5, 1, (3 * 24 + 16 + 3 * 24) * 8 * 321, 321 * 256 * 20 * MULS_FP)

    # K4 at the pairing check's 2 lanes
    xp, yp = ops.to_affine(ops.FP_FIELD, tuple(c[:2] for c in P))
    q2 = [host.jac_mul_raw(host.FP2_OPS, host.G2_GEN, int(k)) for k in rng.integers(1, 1 << 62, 2)]
    Q = tuple(torch.as_tensor(c).to(dev) for c in g2mod.from_ints(q2))
    xq, yq = ops.to_affine(ops.FP2_FIELD, Q)
    x_bits = bin(-host.BLS_X)[3:]
    miller_muls = 157 * len(x_bits) + 52 * x_bits.count("1")
    record("miller", "kateth_tpu_torch/csrc/miller.cu", "kateth_tpu/pallas_pairing.py:415",
           lambda: cuda_pairing.miller_loop_affine(xp, yp, xq, yq),
           lambda: cuda_pairing.miller_loop_affine_plain(xp, yp, xq, yq),
           5, 1, (2 * 24 + 4 * 24 + 288) * 8 * 2, 2 * miller_muls * MULS_FP)

    # K5 at the single lane of the final exponentiation, after the easy part
    f = cuda_pairing.miller_loop_affine(xp[:1], yp[:1], xq[:1], yq[:1])
    f = fp12.mul(fp12.conj(f), fp12.inv(f))
    f = fp12.mul(fp12.frob(fp12.frob(f)), f)
    hard_muls = 5 * (64 * 18 + 6 * 54) + 7 * 54 + 3 * 15 + 18
    record("hard_part", "kateth_tpu_torch/csrc/hard_part.cu", "kateth_tpu/pallas_pairing.py:435",
           lambda: cuda_pairing.hard_part(f), lambda: cuda_pairing.hard_part_plain(f),
           5, 1, 2 * 288 * 8, hard_muls * MULS_FP)
    return out


def main_path(dev, smi: str) -> dict:
    from kateth_tpu_torch import cuda_lib
    from kateth_tpu_torch.kzg import Kzg, KzgError
    from kateth_tpu_torch.kzg.setup import DEFAULT_TRUSTED_SETUP

    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    kzg = Kzg.load_json(DEFAULT_TRUSTED_SETUP, device=dev)
    torch.cuda.synchronize()
    log(f"main path: load_json {time.perf_counter() - t0:.2f} s")

    def run(case, fn):
        want = case["output"]
        try:
            got = fn()
        except KzgError:
            if want is not None:
                raise
            return
        if want is None or got is not want:
            raise AssertionError(f"expected {want}, got {got}")

    t0 = time.perf_counter()
    counts = {}
    for op in ("verify_blob_kzg_proof_batch", "verify_blob_kzg_proof"):
        names = sorted(os.listdir(os.path.join(VECTORS, op)))
        for name in names:
            case = parse_vector(os.path.join(VECTORS, op, name, "data.yaml"))
            i = case["input"]
            try:
                if op == "verify_blob_kzg_proof":
                    run(case, lambda: kzg.verify_blob_kzg_proof(
                        i["blob"], i["commitment"], i["proof"]))
                else:
                    run(case, lambda: kzg.verify_blob_kzg_proof_batch(
                        i["blobs"], i["commitments"], i["proofs"]))
            except AssertionError as e:
                raise AssertionError(f"{op}/{name}: {e}") from None
        counts[op] = len(names)
    log(f"main path: vectors pass {counts} in {time.perf_counter() - t0:.2f} s")

    case = parse_vector(os.path.join(VECTORS, "verify_blob_kzg_proof_batch", "valid_true_4",
                                     "data.yaml"))["input"]
    batch = tuple(case[k] * 16 for k in ("blobs", "commitments", "proofs"))
    if kzg.verify_blob_kzg_proof_batches([batch]) != [True]:
        raise AssertionError("64-blob batch did not verify")
    n_batches = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verdicts = kzg.verify_blob_kzg_proof_batches([batch] * n_batches)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if verdicts != [True] * n_batches:
        raise AssertionError(f"streaming verdicts {verdicts}")
    log(f"main path: streaming {n_batches} x 64 blobs in {dt:.3f} s = "
        f"{64 * n_batches / dt:.1f} proofs/s [{smi}]")
    launches = dict(cuda_lib.LAUNCHES)
    log(f"main path: launches {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    from kateth_tpu_torch import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s into {cuda_lib.build_dir()}")
    for lib in sorted(cuda_lib.LIBRARIES):
        with open(os.path.join(cuda_lib.build_dir(), f"lib{lib}.log")) as f:
            log(f"build: lib{lib}: " + "; ".join(ptxas_summary(f.read())))

    entries = kernel_phases(dev, smi)
    launches = main_path(dev, smi)
    for e in entries:
        e["launches"] = launches[e["name"]]
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
