#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kateth_tpu_torch) on one NVIDIA GPU.

Phases, one line each; any failure exits non-zero before the last line:

1. device: the card's name and power limit (nvidia-smi); no CUDA -> fail.
2. build: compile the CUDA kernels from kateth_tpu_torch/csrc, one nvcc
   process per source, all at once.
3. kernels: each of the eight kernels at its main-path shape, held bit for
   bit against its plain PyTorch version on the same inputs on the card,
   with the median time of each (CUDA events, after a warm-up); K1 also
   checked over Fr and Fp at ragged widths (1, 127, 129, 4,097 and 262,145
   lanes), with a broadcast (1, D) x (n, D) pair and with operands that are
   not 16-byte aligned, and timed over Fp at the point formulas' widths
   (128 and 8,192 lanes: a call, the device's share, and the host time of
   a call over 1,000 calls); K2 checked at 1, 2, 127, 128, 129 and 4,097
   lanes with (p+1)/4, p - 2 and r - 2 and at 129 lanes with e = 1, 2, 3,
   2^100, 2^511 + 1 and a random 500-bit e over both fields, then timed at
   128 lanes ((p+1)/4) and 1 lane (p - 2); the team kernels K3 also checked
   at 1, 3 and 4,096 lanes, K4 at 1 lane, K5 at 3 lanes, K6 at 3 and 64
   lanes (scalars 0, 1, r - 1 and random ones, the point at infinity among
   the bases), K7 at 1 chain, a partial block and 64 x 4,096 points with
   identity rows, repeated points and P, -P pairs, and K8 also at 1 chain,
   a partial block and one comb column, then timed at the commit's one
   launch over all 22 columns.
4. paths, each run with the launch counters zeroed just before and read
   just after, each required to launch its own kernels:
   - batch verify: Kzg.load_json of the mainnet setup, every vendored
     verify_blob_kzg_proof_batch and verify_blob_kzg_proof vector, then a
     64-blob batch through verify_blob_kzg_proof_batches, which captures
     the batch's CUDA graph (its memory and its launches a replay are
     printed), then the streaming loop of verify_blob_kzg_proof_batches
     over 8 x 64 blobs with its dispatches under
     torch.cuda.set_sync_debug_mode("error"): a dispatch that waited for
     the device would raise (proofs/s, for information);
   then, apart from the paths' counts: the graph's verdict and packed
   masks held bit for bit against a direct eager call of
   protocol.verify_blob_batch_fused and pairing_check on the valid batch
   and on four bad 64-blob batches (a non-canonical blob element, a
   commitment with a bad encoding, a proof off the curve, a wrong proof),
   each also through verify_blob_kzg_proof_batch (its KzgError or False);
   the launches of a replay equal to those of the eager call; a 128-blob
   batch, whose graph is captured into the same memory pool (the bytes
   each capture reserved are printed); two threads sharing the Kzg, one
   verifying the valid batch and one the wrong proof, 4 times each, each
   required to get its own verdicts; and eager against graph streaming
   proofs/s, 8 x 64 blobs, six times each in turns;
   - single-point verify: every verify_kzg_proof vector, through the
     verify_kzg graph of the Kzg's graph cache (captured at the first; its
     replays must rise; its pool bytes and a replay's launches printed);
   - commit and prove with the default comb (comb_h = 12): the first
     commit, which builds the comb table (seconds, peak memory) and
     captures the commit graph, every blob_to_kzg_commitment,
     compute_kzg_proof and compute_blob_kzg_proof vector (a single blob
     runs on 1 lane: the commit, prove and validate_g1 graphs of size 1
     must replay), and one 64-blob
     blobs_to_kzg_commitments (commitments/s), which must launch K8 once;
   then, apart from the paths' counts: the verify_kzg, commit, prove and
   validate_g1 graphs' outputs held bit for bit against the same programs
   run eagerly (a twin Kzg with no graph cache, the same staging) on valid
   inputs and on a proof with a bad encoding, a commitment off the curve, a
   non-canonical blob element, and the cases with two bad inputs (a bad
   proof and a commitment off the curve; a non-canonical blob element and
   a bad z; a commitment with a bad encoding and a blob of the wrong
   length; a commitment off the curve and a non-canonical blob element),
   each dispatch under torch.cuda.set_sync_debug_mode("error") and each
   case also through the public API, graph and eager (its result or the
   JAX package's KzgError); a replay's launches equal to an eager call's
   for each program; every capture's pool bytes and the eager commit's own
   peak working set; two threads on one Kzg, one committing 64 blobs and
   one verifying a valid and a wrong batch; and graph against eager times,
   six runs each in turns, of a single-point verify, a 64-blob commit and a
   64-blob compute_blob_kzg_proofs; then one block's pass (block_pass):
   2, 3 and 6 vector blobs (on 2, 4 and 8 lanes) committed, proved at z
   and proved as blob proofs, and 6 vector triples verified (True, then
   False with one wrong proof), each output the vectors'; Kzg.lanes over
   the pass, the size-8 captures' pool bytes, and a 6-blob commit and blob
   proofs timed;
   - commit and prove with the windowed Pippenger (comb_h = 0), on a
     second Kzg with a graph cache of its own: every blob_to_kzg_commitment,
     compute_kzg_proof and compute_blob_kzg_proof vector through its
     1-lane commit, prove and validate_g1 graphs (the commit and prove
     scans: a head, a step replayed once a window, a tail; their replays
     must rise);
   then, apart from the paths' counts: the windowed commit and prove
   graphs' outputs held bit for bit against an eager twin on a valid
   64-blob commit, valid 64-blob blob proofs, a non-canonical blob element
   and a bad z, each dispatch under sync debug mode "error" and each case
   through the public API; a 64-blob commit's replays launching what the
   eager call launches, K7 32 times; the prove scan's step graph required
   to be the commit scan's (one step graph a batch size, shared); each
   capture's graph nodes and pool; the eager twin's peak bytes allocated
   for a 64-blob commit and for 64-blob blob proofs beside the windowed
   Kzg's whole pool (its captures' reserves, and its segments); and graph
   against eager times, three runs each in turns, of a 64-blob commit and
   a 64-blob compute_blob_kzg_proofs; then the block pass on this Kzg;
   - form conversion: 64 mainnet blobs (the valid blob_to_kzg_commitment
     vectors' blobs, repeated) through blobs_to_coefficients and back
     through coefficients_to_blobs, which must give the same bytes; two
     blobs' coefficients evaluated by Horner in Python integers at four
     bit-reversed roots must give the blobs' elements; a wrong coefficient
     count must raise KzgError;
   - the uncached device setup load: TorchSetup.load_json of the mainnet
     setup with no cache, whose eight tensors must equal the setup the
     batch-verify path loaded; its 65 G2 points decoded on the card (timed
     apart) must equal host.g2_decompress and compress back to the JSON's
     encodings (timed); a setup with one G2 point on the twist but outside
     G2 must raise KzgError;
   - sharding over an NCCL group of world size 1: sharded_ntt_from_brp of
     the 64 blobs must equal lagrange_brp_to_monomial, sharded_msm of one
     4096-point MSM must equal msm.msm in affine, sharded_commit_comb of
     the 64 blobs (with the comb path's table) must give their vectors'
     commitments, and a small windowed sharded_commit must equal msm.msm.
   A vector's output must match; `output: null` must raise KzgError.
   After the paths, the device memory reserved.
5. the kernels JSON line (with K1's launches by lane count), the
   nvidia-smi line, and the result line.

Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
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
    or list fields of quoted hex strings, then `output:`: a boolean, null,
    a hex string or a list of hex strings."""
    inp, out, key = {}, None, None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("output:"):
                v = line.split(":", 1)[1].strip()
                if v == "":  # a list of hex strings follows
                    out = []
                elif v in ("true", "false", "null"):
                    out = {"true": True, "false": False, "null": None}[v]
                else:
                    out = bytes.fromhex(v.strip("'")[2:])
            elif line.startswith("- "):
                out.append(bytes.fromhex(line[2:].strip("'")[2:]))
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
    """'kernel: R registers, S bytes stack, M bytes smem' for each entry
    function in an nvcc -Xptxas -v log."""
    out, name = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            name = next(k for k in re.findall(r"[a-z0-9_]+_kernel", mangled))
            name = re.sub(r"^.*\d+(?=[a-z])", "", name)  # the length prefix
            name += "".join(f"<{f}>" for f in ("FrField", "FpField") if f in mangled)
            name += {"Lb1E": "<aligned16>", "Lb0E": "<unaligned>"}.get(
                next(iter(re.findall(r"Lb[01]E", mangled)), ""), "")
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            stack = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {m.group(1)} registers, {stack} bytes stack, "
                       f"{smem.group(1) if smem else 0} bytes smem")
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


def device_ms_per_call(fn, runs: int, kernel: str) -> float | None:
    """Device time per call of fn() spent in the CUDA kernels whose name
    holds `kernel`, from torch.profiler; None if it records none.  Unlike
    cuda_time_ms it leaves out the host's share of a short call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA and kernel in ev.name]
    return sum(us) / runs / 1e3 if us else None


def host_ms_per_call(fn, calls: int) -> float:
    """Milliseconds of host time per call of fn() over `calls` calls, with
    no synchronisation inside the loop (one before and one after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e3


def schedule_products(header: str, what: str = "kProgramProducts") -> list[int]:
    """The Fp products (or, with what = "kProgramProductRounds", the
    product rounds) of each program of a team kernel's schedule, from
    kateth_tpu_torch/csrc/<header>."""
    with open(os.path.join(ROOT, "kateth_tpu_torch", "csrc", header)) as f:
        m = re.search(what + r"\[\d+\] = \{([^}]*)\};", f.read())
    return [int(v) for v in m.group(1).split(",")]


def max_abs_err(got, want) -> int:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(int((g - w).abs().max()) for g, w in zip(got, want))


def kernel_phases(dev, smi: str) -> list[dict]:
    from kateth_tpu_torch import cuda_pairing, host
    from kateth_tpu_torch.curves import cuda_msm
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
        d[1:2] = 0
        return torch.as_tensor(d).to(dev)

    out = []

    def timed(name, kernel_fn, plain_fn, runs, plain_runs, nbytes, muls):
        """Check kernel_fn against plain_fn bit for bit, then time both."""
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version (max {err})")
        ms = cuda_time_ms(kernel_fn, runs)
        plain_ms = cuda_time_ms(plain_fn, plain_runs)
        bytes_ms = nbytes / PEAK_BYTES_S * 1e3
        ops_ms = muls / PEAK_WIDE_MULS_S * 1e3
        return err, ms, plain_ms, bytes_ms, ops_ms

    def record(name, src, replaces, kernel_fn, plain_fn, runs, plain_runs, nbytes, muls):
        err, ms, plain_ms, bytes_ms, ops_ms = timed(
            name, kernel_fn, plain_fn, runs, plain_runs, nbytes, muls)
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
    k1 = record("mont_mul", src, "kateth_tpu/fields/pallas_mont.py:177",
                lambda: cuda_mont.mont_mul(FR, a, b), lambda: cuda_mont.mont_mul_plain(FR, a, b),
                20, 3, 3 * a.numel() * 8, a.shape[0] * MULS_FR)
    k1["device_ms"] = device_ms_per_call(lambda: cuda_mont.mont_mul(FR, a, b), 20, "mont_mul_kernel")
    log(f"kernel mont_mul: device time {k1['device_ms']} ms per launch, "
        f"{k1['device_ms'] / k1['bound_ms']:.2f}x its bound [{smi}]")
    # K1 at ragged widths over both fields, a broadcast pair, and operands
    # 8 bytes past a 16-byte boundary (the kernel's 8-byte path)
    for spec in (FR, FP):
        D = spec.n_digits
        for lanes in (1, 127, 129, 4097, 262145):
            a, b = field_elems(spec, lanes), field_elems(spec, lanes).flip(0)
            if max_abs_err(cuda_mont.mont_mul(spec, a, b), cuda_mont.mont_mul_plain(spec, a, b)):
                raise AssertionError(f"mont_mul over {spec.name} at {lanes} lanes differs from plain")
        a, b = field_elems(spec, 1), field_elems(spec, 4097)
        if max_abs_err(cuda_mont.mont_mul(spec, a, b), cuda_mont.mont_mul_plain(spec, a, b)):
            raise AssertionError(f"mont_mul over {spec.name}, (1, {D}) x (4097, {D}), differs")
        # contiguous views 8 bytes past a 16-byte boundary: the wrapper
        # hands them over as they are
        buf = torch.empty(2 * 4097 * D + 1, dtype=torch.int64, device=dev)
        a, b = (buf[1 + k * 4097 * D:1 + (k + 1) * 4097 * D].view(4097, D) for k in range(2))
        a.copy_(field_elems(spec, 4097))
        b.copy_(field_elems(spec, 4097))
        if a.data_ptr() % 16 != 8 or b.data_ptr() % 16 != 8:
            raise AssertionError("the unaligned operands are aligned")
        if max_abs_err(cuda_mont.mont_mul(spec, a, b), cuda_mont.mont_mul_plain(spec, a, b)):
            raise AssertionError(f"mont_mul over {spec.name}, unaligned operands, differs")
        log(f"kernel mont_mul ({spec.name}): equal to plain at 1, 127, 129, 4097 and 262145 "
            f"lanes, (1, {D}) x (4097, {D}) and unaligned operands")
    # K1 over Fp at the widths of the plain point formulas, where most of
    # its launches are: 128 lanes (verify) and 8,192 (the comb's sums); a
    # call between CUDA events, the device's share of it, and the host
    # time of a call over 1,000 calls with one synchronisation at the end
    k1["widths"] = []
    for lanes in (128, 8192):
        a, b = field_elems(FP, lanes), field_elems(FP, lanes).flip(0)
        _, ms, plain_ms, bytes_ms, ops_ms = timed(
            "mont_mul", lambda: cuda_mont.mont_mul(FP, a, b),
            lambda: cuda_mont.mont_mul_plain(FP, a, b), 50, 5, 3 * a.numel() * 8, lanes * MULS_FP)
        dev_ms = device_ms_per_call(lambda: cuda_mont.mont_mul(FP, a, b), 100, "mont_mul_kernel")
        host_ms = host_ms_per_call(lambda: L.mont_mul(FP, a, b), 1000)
        k1["widths"].append({"field": "fp", "lanes": lanes, "ms": ms, "device_ms": dev_ms,
                             "host_ms": host_ms, "plain_ms": plain_ms,
                             "bound_ms": max(bytes_ms, ops_ms)})
        log(f"kernel mont_mul (Fp, {lanes} lanes): equal to plain; {ms:.4f} ms a call, device "
            f"time {dev_ms} ms, host time {host_ms:.4f} ms a call over 1000 calls (plain "
            f"{plain_ms:.2f} ms, bound {max(bytes_ms, ops_ms):.6f} ms) [{smi}]")

    # K2, a team of 4 threads a lane running the sliding-window chain of
    # cuda_mont.pow_chain: bit for bit at 1, 2, 127, 128, 129 and 4,097
    # lanes with the port's exponents ((p+1)/4 and p - 2 over Fp, r - 2 over
    # Fr), and at 129 lanes over both fields with e = 1, 2, 3, 2^100,
    # 2^511 + 1 and a random 500-bit e; lanes 0-3 are N - 1, 0, 1 and one
    def pow_inputs(spec, lanes):
        a = field_elems(spec, lanes)
        if lanes > 3:
            a[2] = torch.as_tensor(L.int_to_digits(1, spec.n_digits)).to(dev)
            a[3] = spec.tensor("one_mont", dev)
        return a

    e_sqrt, e_inv, e_fr = (FP.modulus + 1) // 4, FP.modulus - 2, FR.modulus - 2
    e500 = int.from_bytes(rng.bytes(63), "big") >> 4 | 1 << 499
    checks = [(spec, e, lanes) for spec, e in ((FP, e_sqrt), (FP, e_inv), (FR, e_fr))
              for lanes in (1, 2, 127, 128, 129, 4097)]
    checks += [(spec, e, 129) for spec in (FP, FR)
               for e in (1, 2, 3, 1 << 100, (1 << 511) + 1, e500)]
    for spec, e, lanes in checks:
        a = pow_inputs(spec, lanes)
        if max_abs_err(cuda_mont.pow_const(spec, a, e), cuda_mont.pow_const_plain(spec, a, e)):
            raise AssertionError(f"pow_chain over {spec.name}, e of {e.bit_length()} bits, "
                                 f"{lanes} lanes, differs from its plain version")
    log(f"kernel pow_chain: equal to plain in {len(checks)} checks ((p+1)/4, p - 2 and r - 2 at "
        "1, 2, 127, 128, 129 and 4097 lanes; e = 1, 2, 3, 2^100, 2^511 + 1 and a random "
        "500-bit e over Fp and Fr at 129 lanes)")
    # timed at the G1 square root over the 2B = 128 decompression lanes, and
    # at the 1 lane of the easy part's inverse (p - 2); the bound counts the
    # chain's products, a chain of dependent products per lane whose
    # latency, not the card's rate, is the floor at these widths
    chain = cuda_mont.pow_chain(e_sqrt)
    a = pow_inputs(FP, 128)
    k2 = record("pow_chain", src, "kateth_tpu/fields/pallas_mont.py:253",
                lambda: cuda_mont.pow_const(FP, a, e_sqrt),
                lambda: cuda_mont.pow_const_plain(FP, a, e_sqrt),
                20, 2, 2 * a.numel() * 8, 128 * chain.n_products * MULS_FP)
    k2["chain_products"] = chain.n_products
    a1 = pow_inputs(FP, 1)
    _, ms1, plain1, bytes1, ops1 = timed(
        "pow_chain", lambda: cuda_mont.pow_const(FP, a1, e_inv),
        lambda: cuda_mont.pow_const_plain(FP, a1, e_inv), 20, 2, 2 * a1.numel() * 8,
        cuda_mont.pow_chain(e_inv).n_products * MULS_FP)
    k2["one_lane"] = {"e": "p - 2", "chain_products": cuda_mont.pow_chain(e_inv).n_products,
                      "ms": ms1, "plain_ms": plain1, "bound_ms": max(bytes1, ops1)}
    log(f"kernel pow_chain: (p+1)/4 is {chain.n_products} dependent products a lane (window "
        f"{chain.window}; bit by bit {e_sqrt.bit_length() - 1 + bin(e_sqrt).count('1') - 1}); "
        f"1 lane, p - 2 ({k2['one_lane']['chain_products']} products): {ms1:.4f} ms (plain "
        f"{plain1:.2f} ms, bound {max(bytes1, ops1):.6f} ms) [{smi}]")

    # K3, a team of threads per lane: bit for bit at 1 lane, a partial
    # warp, 3 lanes (single verify) and 4,096 (the setup's subgroup check),
    # then timed at the fused verify shape: 5B + 1 = 321 lanes, 3B + 1
    # random scalars and 2B subgroup lanes with scalar r
    pts = [host.jac_mul_raw(host.FP_OPS, host.G1_GEN, int(k))
           for k in rng.integers(1, 1 << 62, 64)]

    def ladder_inputs(lanes, n_random):
        P = tuple(torch.as_tensor(np.resize(c, (lanes, 24))).to(dev) for c in g1mod.from_ints(pts))
        sc = [L.int_to_digits(int.from_bytes(rng.bytes(32), "big") % host.R, 16)
              for _ in range(n_random)] + [L.int_to_digits(host.R, 16)] * (lanes - n_random)
        if lanes > 2:
            sc[1] = L.int_to_digits(0, 16)
        return P, torch.as_tensor(np.stack(sc)).to(dev)

    for lanes in (1, 3, 4096):
        P, sc = ladder_inputs(lanes, max(1, lanes - 1))
        err = max_abs_err(cuda_mont.g1_scalar_mul(P, sc), cuda_mont.g1_scalar_mul_plain(P, sc))
        if err:
            raise AssertionError(f"g1_ladder at {lanes} lanes differs from its plain version")
        log(f"kernel g1_ladder ({lanes} lanes): equal to plain")
    P, sc = ladder_inputs(321, 193)
    (g1_products,) = schedule_products("schedule_g1.cuh")
    record("g1_ladder", src, "kateth_tpu/fields/pallas_mont.py:452",
           lambda: cuda_mont.g1_scalar_mul(P, sc),
           lambda: cuda_mont.g1_scalar_mul_plain(P, sc),
           20, 1, (3 * 24 + 16 + 3 * 24) * 8 * 321, 321 * 256 * g1_products * MULS_FP)

    # K4 at the pairing check's 2 lanes
    xp, yp = ops.to_affine(ops.FP_FIELD, tuple(c[:2] for c in P))
    q2 = [host.jac_mul_raw(host.FP2_OPS, host.G2_GEN, int(k)) for k in rng.integers(1, 1 << 62, 2)]
    Q = tuple(torch.as_tensor(c).to(dev) for c in g2mod.from_ints(q2))
    xq, yq = ops.to_affine(ops.FP2_FIELD, Q)
    # the Fp products of the team schedule (constant factors folded away)
    products = schedule_products("schedule_miller.cuh")
    miller_muls = sum(products[int(b)] for b in bin(-host.BLS_X)[3:])
    one = (xp[:1], yp[:1], xq[:1], yq[:1])
    if max_abs_err(cuda_pairing.miller_loop_affine(*one), cuda_pairing.miller_loop_affine_plain(*one)):
        raise AssertionError("miller at 1 lane differs from its plain version")
    log("kernel miller (1 lane): equal to plain")
    record("miller", "kateth_tpu_torch/csrc/miller.cu", "kateth_tpu/pallas_pairing.py:415",
           lambda: cuda_pairing.miller_loop_affine(xp, yp, xq, yq),
           lambda: cuda_pairing.miller_loop_affine_plain(xp, yp, xq, yq),
           20, 1, (2 * 24 + 4 * 24 + 288) * 8 * 2, 2 * miller_muls * MULS_FP)

    # K5, a block of threads per lane, on cyclotomic values: the Miller
    # values of 2 lanes and a random Fp12 value through the easy part;
    # checked at 3 lanes, then timed at the single lane of a verify
    f = cuda_pairing.miller_loop_affine(xp, yp, xq, yq)
    f = torch.cat([f, field_elems(FP, 12).reshape(1, 2, 3, 2, FP.n_digits)])
    f = fp12.mul(fp12.conj(f), fp12.inv(f))
    f = fp12.mul(fp12.frob(fp12.frob(f)), f)
    if max_abs_err(cuda_pairing.hard_part(f), cuda_pairing.hard_part_plain(f)):
        raise AssertionError("hard_part at 3 lanes differs from its plain version")
    log("kernel hard_part (3 lanes): equal to plain")
    # the schedule's products and product rounds: five powers, each a
    # squaring (program 0) or a squaring and a product (program 1) per bit
    # of |x| after its leading one, and the five glue steps (programs 2-6)
    products = schedule_products("schedule_hard_part.cuh")
    rounds = schedule_products("schedule_hard_part.cuh", "kProgramProductRounds")
    per_power = lambda c: sum(c[int(b)] for b in bin(-host.BLS_X)[3:])  # noqa: E731
    hard_muls = 5 * per_power(products) + sum(products[2:])
    log(f"kernel hard_part: {hard_muls} Fp products a lane, "
        f"{5 * per_power(rounds) + sum(rounds[2:])} product rounds on its critical path")
    f1 = f[:1]
    record("hard_part", "kateth_tpu_torch/csrc/hard_part.cu", "kateth_tpu/pallas_pairing.py:435",
           lambda: cuda_pairing.hard_part(f1), lambda: cuda_pairing.hard_part_plain(f1),
           20, 1, 2 * 288 * 8, hard_muls * MULS_FP)

    # K6, a warp per lane: bit for bit at 3 and 64 lanes, bases the point
    # at infinity, -G2 and random points, scalars r - 1, 0, 1 and random
    # ones; then timed at the single lane of verify_kzg_proof: z (-G2), 256
    # steps of the schedule's Fp products (20 Fp2 products, 3 Fp products
    # each)
    neg_g2 = ops.pneg(ops.FP2_FIELD, tuple(torch.as_tensor(c[None]).to(dev) for c in g2mod.GENERATOR))
    gx, gy, gz = host.G2_GEN
    q2 = [host.jac_infinity(host.FP2_OPS), (gx, host.fp2_neg(gy), gz)] + [
        host.jac_mul_raw(host.FP2_OPS, host.G2_GEN, int(k)) for k in rng.integers(1, 1 << 62, 6)]
    for lanes in (3, 64):
        Q = tuple(torch.as_tensor(np.resize(c, (lanes, 2, 24))).to(dev) for c in g2mod.from_ints(q2))
        # 7 scalars against 8 bases: over 64 lanes each base meets each scalar
        ks = [host.R - 1, 0, 1] + [int.from_bytes(rng.bytes(32), "big") % host.R for _ in range(4)]
        sc = torch.as_tensor(np.resize(np.stack([L.int_to_digits(k, 16) for k in ks]), (lanes, 16)))
        sc = sc.to(dev)
        if max_abs_err(cuda_pairing.g2_scalar_mul(Q, sc), cuda_pairing.g2_scalar_mul_plain(Q, sc)):
            raise AssertionError(f"g2_ladder at {lanes} lanes differs from its plain version")
        log(f"kernel g2_ladder ({lanes} lanes): equal to plain")
    z = torch.as_tensor(L.int_to_digits(int.from_bytes(rng.bytes(32), "big") % host.R, 16)[None]).to(dev)
    (g2_products,) = schedule_products("schedule_g2.cuh")
    record("g2_ladder", "kateth_tpu_torch/csrc/g2_ladder.cu", "kateth_tpu/pallas_pairing.py:344",
           lambda: cuda_pairing.g2_scalar_mul(neg_g2, z),
           lambda: cuda_pairing.g2_scalar_mul_plain(neg_g2, z),
           10, 1, (6 * 48 + 16) * 8, 256 * g2_products * MULS_FP)

    # K7, a team of 8 threads a chain: bit for bit at 1 chain and at 45
    # (not a whole block of 8), then at one window of the 64-blob windowed
    # commit, 64 x 4096 points in 32,768 chains of 8 additions (12
    # products each), timed there; some chains hold an identity row, a
    # point twice in a row (the doubling case) or a point and its negation
    src = "kateth_tpu_torch/csrc/msm.cu"
    P = [torch.as_tensor(np.resize(c, (64 * 4096, 24))).to(dev) for c in g1mod.from_ints(pts)]
    g = cuda_msm.CHAIN
    rows = torch.arange(64 * 4096, device=dev).reshape(-1, g)
    ident = rows[0:4096:3, 2]
    P[0][ident], P[1][ident], P[2][ident] = 0, FP.tensor("one_mont", dev), 0
    rep = rows[1:4096:3, 4]
    for c in P:
        c[rep + 1] = c[rep]
    neg = rows[2:4096:3, 6]
    P[0][neg + 1], P[2][neg + 1] = P[0][neg], P[2][neg]
    P[1][neg + 1] = L.neg(FP, P[1][neg])
    P = tuple(c.reshape(64, 4096, 24) for c in P)
    flat = tuple(c.reshape(-1, 24) for c in P)
    for what, pts_k in (("1 chain", tuple(c[:g] for c in flat)),
                        ("45 chains", tuple(c[:45 * g] for c in flat)),
                        ("64 x 4096 points", P)):
        if max_abs_err(cuda_msm.chain_prefix(pts_k, g), cuda_msm.chain_prefix_plain(pts_k, g)):
            raise AssertionError(f"prefix_scan at {what} differs from its plain version")
        log(f"kernel prefix_scan ({what}): equal to plain")
    lanes = 64 * 4096
    record("prefix_scan", src, "kateth_tpu/curves/pallas_msm.py:87",
           lambda: cuda_msm.chain_prefix(P, g),
           lambda: cuda_msm.chain_prefix_plain(P, g),
           20, 2, 2 * 3 * lanes * 24 * 8, lanes * 12 * MULS_FP)

    # K8 on gathered affine comb rows (about one in a hundred the identity):
    # checked at 1 chain, a partial block of 45 chains and one column of the
    # 64-blob commit (64 x 4096 rows, 8,192 chains), then timed at the
    # commit's one launch over all 22 columns (22 x 64 x 4096 rows gathered
    # at random, 180,224 chains of 32 additions; the bound counts the 11
    # products of a mixed addition, the schedule does 12: Z1 Z2 by a SEL)
    aff = [host.jac_to_affine(host.FP_OPS, p) for p in pts]
    ax = np.resize(np.stack([FP.from_int(a[0]) for a in aff]), (64, 4096, 24))
    ay = np.resize(np.stack([FP.from_int(a[1]) for a in aff]), (64, 4096, 24))
    flags = rng.random((64, 4096)) > 0.01
    ax = torch.as_tensor(np.where(flags[..., None], ax, 0)).to(dev)
    ay = torch.as_tensor(np.where(flags[..., None], ay, FP.one_mont)).to(dev)
    flags = torch.as_tensor(flags).to(dev)
    g = cuda_msm.COMB_CHAIN
    flat = (ax.reshape(-1, 24), ay.reshape(-1, 24), flags.reshape(-1))
    for what, (xs, ys, fs) in (("1 chain", tuple(c[:g] for c in flat)),
                               ("45 chains", tuple(c[:45 * g] for c in flat)),
                               ("64 x 4096 rows", (ax, ay, flags))):
        if max_abs_err(cuda_msm.comb_chain_sum(xs, ys, fs), cuda_msm.comb_chain_sum_plain(xs, ys, fs, g)):
            raise AssertionError(f"comb_chain_sum at {what} differs from its plain version")
        log(f"kernel comb_chain_sum ({what}): equal to plain")
    d = 22
    pick = torch.as_tensor(rng.integers(0, 64 * 4096, (d, 64, 4096))).to(dev)
    ax, ay, flags = ax.reshape(-1, 24)[pick], ay.reshape(-1, 24)[pick], flags.reshape(-1)[pick]
    lanes = d * 64 * 4096
    chains = lanes // g
    record("comb_chain_sum", src, "kateth_tpu/curves/pallas_msm.py:138",
           lambda: cuda_msm.comb_chain_sum(ax, ay, flags),
           lambda: cuda_msm.comb_chain_sum_plain(ax, ay, flags, g),
           10, 1, (2 * lanes * 24 + lanes + 3 * chains * 24) * 8, lanes * 11 * MULS_FP)
    return out


#: the kernels each path of the run must launch
PATH_KERNELS = {
    "batch verify": ("mont_mul", "pow_chain", "g1_ladder", "miller", "hard_part"),
    "single-point verify": ("mont_mul", "pow_chain", "g1_ladder", "miller", "hard_part", "g2_ladder"),
    "commit and prove (comb_h = 12)": ("mont_mul", "pow_chain", "g1_ladder", "comb_chain_sum"),
    "commit and prove (comb_h = 0)": ("mont_mul", "pow_chain", "g1_ladder", "prefix_scan"),
    "form conversion": ("mont_mul",),
    "setup load (uncached)": ("mont_mul", "pow_chain", "g1_ladder", "g2_ladder"),
    "sharding (world of 1)": ("mont_mul", "prefix_scan", "comb_chain_sum"),
}


def drive(path: str, fn, totals: dict, k1_buckets: dict) -> None:
    """Run one path with the launch counters zeroed just before and read
    just after; every kernel of the path must have launched."""
    from kateth_tpu_torch import cuda_lib

    cuda_lib.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    log(f"path {path}: launches {launches}; mont_mul by lanes {cuda_lib.MONT_MUL_LAUNCHES}")
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {missing}")
    for k, v in launches.items():
        totals[k] += v
    for k, v in cuda_lib.MONT_MUL_LAUNCHES.items():
        k1_buckets[k] += v


def run_vectors(op: str, call) -> None:
    """Every vendored vector of `op`: the output must match (bytes, a
    [proof, y] pair or a verdict), and `output: null` must raise KzgError."""
    from kateth_tpu_torch.kzg import KzgError

    t0 = time.perf_counter()
    names = sorted(os.listdir(os.path.join(VECTORS, op)))
    for name in names:
        case = parse_vector(os.path.join(VECTORS, op, name, "data.yaml"))
        want = case["output"]
        try:
            got = call(case["input"])
        except KzgError:
            if want is not None:
                raise AssertionError(f"{op}/{name}: KzgError, expected {want}") from None
            continue
        if isinstance(got, tuple):
            got = list(got)
        if want is None or (got is not want if isinstance(want, bool) else got != want):
            raise AssertionError(f"{op}/{name}: expected {want}, got {got}")
    torch.cuda.synchronize()
    log(f"vectors: {op}: {len(names)} pass in {time.perf_counter() - t0:.2f} s")


def twist_point_outside_g2() -> bytes:
    """The 96-byte encoding of the first point with x = (k, 1) on the twist
    y^2 = x^3 + 4(1 + u) that lies outside G2, by the host's arithmetic."""
    from kateth_tpu_torch import host

    k = 1
    while True:
        x = (k, 1)
        y = host.fp2_sqrt(host.fp2_add(host.fp2_mul(host.fp2_sqr(x), x), host.FP2_OPS.b))
        if y is not None:
            b = bytearray(x[1].to_bytes(48, "big") + x[0].to_bytes(48, "big"))
            b[0] |= 0x80 | (0x20 if host._fp2_is_larger(y) else 0)
            try:
                host.g2_decompress(bytes(b))
            except host.NotInGroup:
                return bytes(b)
        k += 1


def same_affine(p, q) -> bool:
    """X1 Z2 = X2 Z1 and Y1 Z2 = Y2 Z1 over G1, neither the identity."""
    from kateth_tpu_torch.fields import limbs as L
    from kateth_tpu_torch.fields.specs import FP

    (X1, Y1, Z1), (X2, Y2, Z2) = p, q
    lhs = L.mont_mul(FP, torch.stack([X1, Y1]), Z2)
    rhs = L.mont_mul(FP, torch.stack([X2, Y2]), Z1)
    return torch.equal(lhs, rhs) and not bool(L.is_zero(Z1).any())


def graph_against_eager(kzg, batch, smi: str) -> None:
    """The batch verification's CUDA graph against the eager program: its
    verdict and packed masks bit for bit on the valid batch and four bad
    ones (each also through the public API), a replay's launches against an
    eager call's, and streaming proofs/s of both, in turns.  Its launches
    are no path's: the counters are reset before each path."""
    from kateth_tpu_torch import cuda_lib, host
    from kateth_tpu_torch.kzg import KzgError, protocol

    blobs, comms, proofs = (list(x) for x in batch)

    def with_item(items, i, value):
        items = list(items)
        items[i] = value
        return items

    x = next(x for x in range(1, 100) if host.fp_sqrt((x**3 + 4) % host.P) is None)
    cases = [
        ("valid", (blobs, comms, proofs), True),
        ("non-canonical blob element", (with_item(blobs, 5, b"\xff" * 32 + blobs[5][32:]), comms,
                                        proofs), "non-canonical field element in blob"),
        ("commitment with a bad encoding", (blobs, with_item(comms, 7, bytes(48)), proofs),
         "BadEncoding"),
        ("proof off the curve", (blobs, comms, with_item(proofs, 9, bytes([0x80]) + x.to_bytes(47, "big"))),
         "NotOnCurve"),
        ("wrong proof", (blobs, comms, with_item(proofs, 0, proofs[1])), False),
    ]
    for name, b, want in cases:
        _, args = kzg._verify_batch_stage(*b)
        pc_in, packed = protocol.verify_blob_batch_fused(*args)
        verdict = protocol.pairing_check(*pc_in)[0]
        _, g_verdict, g_packed = kzg._verify_batch_dispatch(*b)
        if not (torch.equal(g_verdict, verdict) and torch.equal(g_packed, packed)):
            raise AssertionError(f"graph: the {name} batch's verdict or masks differ from eager")
        try:
            got = kzg.verify_blob_kzg_proof_batch(*b)
        except KzgError as e:
            got = str(e)
        if got is not want if isinstance(want, bool) else want not in str(got):
            raise AssertionError(f"graph: the {name} batch gave {got!r}, expected {want!r}")
    log("graph: verdict and masks equal to the eager call's on the valid batch and on a "
        "non-canonical blob element, a commitment with a bad encoding, a proof off the curve "
        "and a wrong proof; the public API raises or returns False for each")

    _, args = kzg._verify_batch_stage(*batch)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    pc_in, _ = protocol.verify_blob_batch_fused(*args)
    protocol.pairing_check(*pc_in)
    torch.cuda.synchronize()
    eager = cuda_lib.launch_counts()
    cuda_lib.reset_launch_counts()
    kzg._verify_batch_dispatch(*batch)
    torch.cuda.synchronize()
    replay = cuda_lib.launch_counts()
    if replay != eager:
        raise AssertionError(f"graph: a replay counts {replay}, the eager call {eager}")
    log(f"graph: a replay counts the eager call's launches: {eager['launches']}; "
        f"mont_mul by lanes {eager['mont_mul_lanes']}")

    # a second padded size: its own graph, in the same memory pool
    big = tuple(x * 2 for x in batch)
    if kzg.verify_blob_kzg_proof_batch(*big) is not True:
        raise AssertionError("graph: the 128-blob batch did not verify")
    g64, g128 = kzg._verify_graphs.graphs[64], kzg._verify_graphs.graphs[128]
    log(f"graph: 128-blob batch captured into the 64-blob graph's pool: {g128.pool_bytes} bytes "
        f"allocated, {g128.pool_reserved_bytes} bytes newly reserved (64 blobs: "
        f"{g64.pool_reserved_bytes}); device memory reserved in all "
        f"{torch.cuda.memory_reserved()} bytes [{smi}]")

    # threads sharing the Kzg: each replay's inputs and outputs are its own
    wrong = cases[-1][1]
    results = {"valid": [], "wrong proof": []}

    def worker(name, b):
        for _ in range(4):
            results[name].append(kzg.verify_blob_kzg_proof_batch(*b))

    threads = [threading.Thread(target=worker, args=a) for a in
               (("valid", (blobs, comms, proofs)), ("wrong proof", wrong))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if results != {"valid": [True] * 4, "wrong proof": [False] * 4}:
        raise AssertionError(f"graph: two threads sharing the Kzg gave {results}")
    log("graph: two threads sharing the Kzg, 4 valid and 4 wrong-proof batches, each got its "
        "own verdicts")

    n_batches = 8

    def eager_stream():
        pending = []
        for _ in range(n_batches):
            n, args = kzg._verify_batch_stage(*batch)
            pc_in, packed = protocol.verify_blob_batch_fused(*args)
            pending.append((n, protocol.pairing_check(*pc_in)[0], packed))
        return [kzg._verify_batch_finalize(p) for p in pending]

    runs = {"eager": eager_stream,
            "graph": lambda: kzg.verify_blob_kzg_proof_batches([batch] * n_batches)}
    rates = {k: [] for k in runs}
    for order in (("eager", "graph"), ("graph", "eager")) * 3:
        for mode in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            verdicts = runs[mode]()
            torch.cuda.synchronize()
            rates[mode].append(64 * n_batches / (time.perf_counter() - t0))
            if verdicts != [True] * n_batches:
                raise AssertionError(f"{mode} streaming verdicts {verdicts}")
    for mode, r in rates.items():
        log(f"graph: {mode} streaming {n_batches} x 64 blobs: median "
            f"{statistics.median(r):.1f} proofs/s (min {min(r):.1f}, max {max(r):.1f}, "
            f"{len(r)} runs in turns) [{smi}]")


def flat_tensors(outputs) -> list:
    """A dispatch's outputs (a tuple of tensors, or a list of them or of
    such tuples, one a chunk) as one list of tensors."""
    return [t for x in outputs for t in (x if isinstance(x, (tuple, list)) else (x,))]


def eager_twin(kzg):
    """A Kzg on the same setup and comb table that runs every program
    eagerly: the same API code with no graph cache."""
    from kateth_tpu_torch.kzg import Kzg

    twin = Kzg(kzg.setup)
    twin._graphs = twin._verify_graphs = None
    twin._comb_table = kzg._comb_table
    return twin


def path_graphs_against_eager(kzg, batch, smi: str) -> None:
    """The single-point verify, validation, commit and prove graphs against
    the same programs run eagerly (an eager twin of the Kzg, the same API
    code and staging): their outputs bit for bit on a valid input and on
    each error case, each also through the public API (its result or its
    KzgError); each dispatch under torch.cuda.set_sync_debug_mode("error")
    up to its read-back; a replay's launches against an eager call's; two
    threads on one Kzg, one committing and one verifying batches; the
    graphs' pool bytes and the eager commit's own peak working set; graph
    against eager times, in turns.  Its launches are no path's."""
    from kateth_tpu_torch import cuda_lib, host
    from kateth_tpu_torch.kzg import KzgError

    eager = eager_twin(kzg)
    d = os.path.join(VECTORS, "verify_kzg_proof", "valid_true", "data.yaml")
    point = parse_vector(d)["input"]
    proof, comm, z, y = (point[k] for k in ("proof", "commitment", "z", "y"))
    case = parse_vector(os.path.join(VECTORS, "compute_blob_kzg_proof", "valid_0", "data.yaml"))
    blob, blob_comm = case["input"]["blob"], case["input"]["commitment"]
    blob_proof = case["output"]
    blobs, comms = [blob] * 64, [blob_comm] * 64
    case = parse_vector(os.path.join(VECTORS, "compute_kzg_proof", "valid_0", "data.yaml"))
    p_blobs, p_z, (p_proof, p_y) = [case["input"]["blob"]] * 64, case["input"]["z"], case["output"]
    x = next(x for x in range(1, 100) if host.fp_sqrt((x**3 + 4) % host.P) is None)
    off_curve = bytes([0x80]) + x.to_bytes(47, "big")
    bad_blob = b"\xff" * 32 + blob[32:]
    z_int = int.from_bytes(p_z, "big")
    bad_z = host.R.to_bytes(32, "big")

    def with_item(items, i, value):
        items = list(items)
        items[i] = value
        return items

    # (name, program, dispatch of a Kzg, public call of a Kzg, expected result or message)
    cases = [
        ("valid opening", "verify_kzg", lambda k: k._verify_kzg_dispatch(proof, comm, z, y),
         lambda k: k.verify_kzg_proof(proof, comm, z, y), True),
        ("proof with a bad encoding", "verify_kzg",
         lambda k: k._verify_kzg_dispatch(bytes(48), comm, z, y),
         lambda k: k.verify_kzg_proof(bytes(48), comm, z, y), "invalid G1 point: BadEncoding"),
        ("commitment off the curve", "verify_kzg",
         lambda k: k._verify_kzg_dispatch(proof, off_curve, z, y),
         lambda k: k.verify_kzg_proof(proof, off_curve, z, y), "invalid G1 point: NotOnCurve"),
        ("bad proof and commitment off the curve", "verify_kzg",
         lambda k: k._verify_kzg_dispatch(bytes(48), off_curve, z, y),
         lambda k: k.verify_kzg_proof(bytes(48), off_curve, z, y), "invalid G1 point: BadEncoding"),
        ("64 valid blobs", "commit", lambda k: k._commit_dispatch(blobs),
         lambda k: k.blobs_to_kzg_commitments(blobs), [blob_comm] * 64),
        ("non-canonical blob element", "commit",
         lambda k: k._commit_dispatch(with_item(blobs, 9, bad_blob)),
         lambda k: k.blobs_to_kzg_commitments(with_item(blobs, 9, bad_blob)),
         "non-canonical field element in blob"),
        ("64 valid blobs at z", "prove", lambda k: k._prove_dispatch(p_blobs, [z_int] * 64),
         lambda k: k.compute_kzg_proofs(p_blobs, [p_z] * 64), ([p_proof] * 64, [p_y] * 64)),
        ("non-canonical blob element and a bad z", "prove",
         lambda k: k._prove_dispatch(with_item(p_blobs, 3, bad_blob), with_item([z_int] * 64, 5, 0)),
         lambda k: k.compute_kzg_proofs(with_item(p_blobs, 3, bad_blob), with_item([p_z] * 64, 5, bad_z)),
         "non-canonical field element in blob"),
        ("64 blob proofs", "prove",
         lambda k: k._prove_dispatch(blobs, k._challenges(blobs, comms)),
         lambda k: k.compute_blob_kzg_proofs(blobs, comms), [blob_proof] * 64),
        ("64 valid commitments", "validate_g1", lambda k: k._validate_dispatch(comms),
         lambda k: k.compute_blob_kzg_proofs(blobs, comms), [blob_proof] * 64),
        ("commitment with a bad encoding and a blob of the wrong length", "validate_g1",
         lambda k: k._validate_dispatch(with_item(comms, 7, bytes(48))),
         lambda k: k.compute_blob_kzg_proofs(with_item(blobs, 2, blob[:-1]), with_item(comms, 7, bytes(48))),
         "invalid G1 point: BadEncoding"),
        ("commitment off the curve and a non-canonical blob element", "validate_g1",
         lambda k: k._validate_dispatch(with_item(comms, 7, off_curve)),
         lambda k: k.compute_blob_kzg_proofs(with_item(blobs, 2, bad_blob), with_item(comms, 7, off_curve)),
         "invalid G1 point: NotOnCurve"),
    ]
    for name, program, dispatch, call, want in cases:
        graphs = kzg._graphs.programs[program]
        replays = sum(g.replays for g in graphs.graphs.values())
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = dispatch(kzg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if sum(g.replays for g in graphs.graphs.values()) == replays:
            raise AssertionError(f"path graphs: the {name} case did not replay {program}")
        got, ref = flat_tensors(got), flat_tensors(dispatch(eager))
        if len(got) != len(ref) or not all(
                g.dtype == r.dtype and torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"path graphs: the {name} case's {program} outputs differ from eager")
        for k in (kzg, eager):
            try:
                result = call(k)
            except KzgError as e:
                result = str(e)
            if result != want:
                raise AssertionError(f"path graphs: the {name} case gave {result!r}, expected {want!r}")
    log(f"path graphs: verify_kzg, commit, prove and validate_g1 outputs equal to the eager "
        f"programs' bit for bit in {len(cases)} cases ({', '.join(c[0] for c in cases)}), each "
        f"dispatch with no host sync (sync debug mode \"error\"); the public API gives each "
        f"case's result or KzgError, graph and eager alike")

    for name, dispatch in (("verify_kzg", cases[0][2]), ("commit", cases[4][2]),
                           ("prove", cases[8][2]), ("validate_g1", cases[9][2])):
        counts = {}
        for mode, k in (("eager", eager), ("graph", kzg)):
            torch.cuda.synchronize()
            cuda_lib.reset_launch_counts()
            dispatch(k)
            torch.cuda.synchronize()
            counts[mode] = cuda_lib.launch_counts()
        if counts["graph"] != counts["eager"]:
            raise AssertionError(f"path graphs: a {name} replay counts {counts['graph']}, "
                                 f"the eager call {counts['eager']}")
        log(f"path graphs: a {name} replay counts the eager call's launches: "
            f"{counts['eager']['launches']}")

    # the commit graph's pool against the eager commit's own working set:
    # its peak allocated bytes, and what it newly reserves from an emptied
    # cache (as a capture does)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    eager.blobs_to_kzg_commitments(blobs)
    torch.cuda.synchronize()
    working = torch.cuda.max_memory_allocated() - base
    working_reserved = torch.cuda.max_memory_reserved() - base_reserved
    for name, graphs in sorted(kzg._graphs.programs.items()):
        for size, g in sorted(graphs.graphs.items()):
            log(f"pool: {name} at {size}: {g.pool_bytes} bytes allocated, "
                f"{g.pool_reserved_bytes} bytes newly reserved [{smi}]")
    reserved = kzg._graphs.programs["commit"].graphs[64].pool_reserved_bytes
    log(f"pool: the eager 64-blob commit's peak working set (the table apart) {working} bytes "
        f"allocated, {working_reserved} bytes newly reserved from an emptied cache; the commit "
        f"capture reserved {reserved}, {reserved / working:.3f} x the eager peak [{smi}]")

    # two threads on one Kzg: one commits while the other verifies batches
    wrong = (batch[0], batch[1], with_item(batch[2], 0, batch[2][1]))
    results = {"commit": [], "verify": []}

    def committer():
        for _ in range(3):
            results["commit"].append(kzg.blobs_to_kzg_commitments(blobs) == [blob_comm] * 64)

    def verifier():
        for _ in range(3):
            results["verify"].append((kzg.verify_blob_kzg_proof_batch(*batch),
                                      kzg.verify_blob_kzg_proof_batch(*wrong)))

    threads = [threading.Thread(target=committer), threading.Thread(target=verifier)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if results != {"commit": [True] * 3, "verify": [(True, False)] * 3}:
        raise AssertionError(f"path graphs: two threads on one Kzg gave {results}")
    log("path graphs: two threads on one Kzg, one committing 64 blobs three times and one "
        "verifying a valid and a wrong batch three times, each got its own results")

    # graph against eager, in turns
    ops = {
        "single-point verify_kzg_proof": (lambda k: k.verify_kzg_proof(proof, comm, z, y), True),
        "64-blob blobs_to_kzg_commitments": (lambda k: k.blobs_to_kzg_commitments(blobs),
                                             [blob_comm] * 64),
        "64-blob compute_blob_kzg_proofs": (lambda k: k.compute_blob_kzg_proofs(blobs, comms),
                                            [blob_proof] * 64),
    }
    for op, (fn, want) in ops.items():
        times = {"graph": [], "eager": []}
        for order in (("eager", "graph"), ("graph", "eager")) * 3:
            for mode in order:
                k = kzg if mode == "graph" else eager
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = fn(k)
                times[mode].append((time.perf_counter() - t0) * 1e3)
                if got != want:
                    raise AssertionError(f"path graphs: {mode} {op} gave a wrong result")
        log(f"path graphs: {op}: graph median {statistics.median(times['graph']):.3f} ms "
            f"(runs {min(times['graph']):.3f}-{max(times['graph']):.3f}), eager median "
            f"{statistics.median(times['eager']):.3f} ms (runs {min(times['eager']):.3f}-"
            f"{max(times['eager']):.3f}), 6 runs each in turns [{smi}]")


def windowed_graphs_against_eager(kzg, smi: str) -> None:
    """The windowed commit and proof graphs (comb_h = 0: a head, a step
    replayed once a window, a tail) against the same programs run eagerly
    by an eager twin of the Kzg: their outputs bit for bit on a valid
    64-blob commit, valid 64-blob blob proofs, a non-canonical blob element
    and a bad z, each dispatch under torch.cuda.set_sync_debug_mode("error")
    and each case also through the public API (its result or KzgError); a
    commit's replays launching what an eager call launches (K7 once a
    window); the step graph's nodes and every capture's pool; graph against
    eager times in turns.  Its launches are no path's."""
    from kateth_tpu_torch import cuda_lib, host
    from kateth_tpu_torch.kzg import KzgError

    eager = eager_twin(kzg)
    case = parse_vector(os.path.join(VECTORS, "compute_blob_kzg_proof", "valid_0", "data.yaml"))
    blob, blob_comm, blob_proof = case["input"]["blob"], case["input"]["commitment"], case["output"]
    blobs, comms = [blob] * 64, [blob_comm] * 64
    case = parse_vector(os.path.join(VECTORS, "compute_kzg_proof", "valid_0", "data.yaml"))
    p_blobs, p_z = [case["input"]["blob"]] * 64, case["input"]["z"]
    z_int = int.from_bytes(p_z, "big")
    bad_blobs = list(blobs)
    bad_blobs[9] = b"\xff" * 32 + blob[32:]
    bad_zs = [p_z] * 64
    bad_zs[5] = host.R.to_bytes(32, "big")

    # (name, program, dispatch of a Kzg, public call of the Kzg, expected result or message)
    cases = [
        ("64 valid blobs", "commit", lambda k: k._commit_dispatch(blobs),
         lambda k: k.blobs_to_kzg_commitments(blobs), [blob_comm] * 64),
        ("64 blob proofs", "prove", lambda k: k._prove_dispatch(blobs, k._challenges(blobs, comms)),
         lambda k: k.compute_blob_kzg_proofs(blobs, comms), [blob_proof] * 64),
        ("non-canonical blob element", "commit", lambda k: k._commit_dispatch(bad_blobs),
         lambda k: k.blobs_to_kzg_commitments(bad_blobs), "non-canonical field element in blob"),
        ("bad z", "prove", lambda k: k._prove_dispatch(p_blobs, [z_int] * 5 + [0] + [z_int] * 58),
         lambda k: k.compute_kzg_proofs(p_blobs, bad_zs), "non-canonical field element"),
    ]
    for name, program, dispatch, call, want in cases:
        graphs = kzg._graphs.programs[program]
        replays = sum(g.replays for g in graphs.graphs.values())
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = dispatch(kzg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if sum(g.replays for g in graphs.graphs.values()) == replays:
            raise AssertionError(f"windowed graphs: the {name} case did not replay {program}")
        got, ref = flat_tensors(got), flat_tensors(dispatch(eager))
        if len(got) != len(ref) or not all(
                g.dtype == r.dtype and torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"windowed graphs: the {name} case's {program} outputs differ "
                                 "from eager")
        try:
            result = call(kzg)
        except KzgError as e:
            result = str(e)
        if result != want:
            raise AssertionError(f"windowed graphs: the {name} case gave {result!r}, expected {want!r}")
    log(f"windowed graphs: commit and prove outputs equal to the eager programs' bit for bit in "
        f"{len(cases)} cases ({', '.join(c[0] for c in cases)}), each dispatch with no host sync "
        f"(sync debug mode \"error\"); the public API gives each case's result or KzgError")

    counts = {}
    for mode, k in (("eager", eager), ("graph", kzg)):
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        k._commit_dispatch(blobs)
        torch.cuda.synchronize()
        counts[mode] = cuda_lib.launch_counts()
    if counts["graph"] != counts["eager"]:
        raise AssertionError(f"windowed graphs: a commit's replays count {counts['graph']}, "
                             f"the eager call {counts['eager']}")
    if counts["graph"]["launches"]["prefix_scan"] != 32:
        raise AssertionError(f"windowed graphs: a 64-blob commit launched K7 "
                             f"{counts['graph']['launches']['prefix_scan']} times, not 32")
    log(f"windowed graphs: a 64-blob commit's replays count the eager call's launches: "
        f"{counts['eager']['launches']}; mont_mul by lanes {counts['eager']['mont_mul_lanes']}")

    cache = kzg._graphs
    step = cache.programs["commit"].graphs[64].step
    if cache.programs["prove"].graphs[64].step is not step:
        raise AssertionError("windowed graphs: the prove scan captured a step of its own")
    for name in ("commit", "prove"):
        scan = cache.programs[name].graphs[64]
        for part in ("head", "step", "tail"):
            g = getattr(scan, part)
            shared = " (the commit's step, shared: no capture)" if name == "prove" and part == "step" else ""
            log(f"pool (comb_h = 0): {name} {part} at 64{shared}: {g.nodes} graph nodes, a replay "
                f"launches {g.launches['launches']}; {g.pool_bytes} bytes allocated, "
                f"{g.pool_reserved_bytes} bytes newly reserved [{smi}]")

    # the whole pool against the eager twin's peaks for the same calls
    peaks = {}
    for op, fn, want in (("64-blob commit", lambda: eager.blobs_to_kzg_commitments(blobs),
                          [blob_comm] * 64),
                         ("64-blob blob proofs", lambda: eager.compute_blob_kzg_proofs(blobs, comms),
                          [blob_proof] * 64)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if fn() != want:
            raise AssertionError(f"windowed graphs: the eager {op} gave a wrong result")
        torch.cuda.synchronize()
        peaks[op] = torch.cuda.max_memory_allocated() - base
    captures = {id(g): g for graphs in cache.programs.values() for x in graphs.graphs.values()
                for g in ((x.head, x.step, x.tail) if hasattr(x, "step") else (x,))}
    whole = sum(g.pool_reserved_bytes for g in captures.values())
    # the graphs' static buffers, outside the pool: inputs, and the heads'
    # outputs
    statics = {t.data_ptr(): t.nbytes for g in captures.values() for t in g.inputs}
    statics.update({t.data_ptr(): t.nbytes for graphs in cache.programs.values()
                    for x in graphs.graphs.values() if hasattr(x, "step") for t in x.head.outputs})
    segments = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(cache.pool))
    log(f"pool (comb_h = 0): the eager twin's peak above its baseline "
        + ", ".join(f"{op} {b} bytes allocated" for op, b in peaks.items())
        + f"; the windowed Kzg's whole pool {whole} bytes newly reserved by its "
        f"{len(captures)} captures ({', '.join(sorted(cache.programs))}; steps shared: "
        f"{len(cache.steps)}), {segments} bytes in the pool's segments, "
        f"{whole / max(peaks.values()):.3f} x the larger eager peak; its static buffers outside "
        f"the pool {sum(statics.values())} bytes [{smi}]")

    ops = {
        "64-blob blobs_to_kzg_commitments": (lambda k: k.blobs_to_kzg_commitments(blobs),
                                             [blob_comm] * 64),
        "64-blob compute_blob_kzg_proofs": (lambda k: k.compute_blob_kzg_proofs(blobs, comms),
                                            [blob_proof] * 64),
    }
    for op, (fn, want) in ops.items():
        times = {"graph": [], "eager": []}
        for order in (("eager", "graph"), ("graph", "eager"), ("eager", "graph")):
            for mode in order:
                k = kzg if mode == "graph" else eager
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = fn(k)
                times[mode].append((time.perf_counter() - t0) * 1e3)
                if got != want:
                    raise AssertionError(f"windowed graphs: {mode} {op} gave a wrong result")
        log(f"windowed graphs: {op} (comb_h = 0): graph median "
            f"{statistics.median(times['graph']):.3f} ms (runs {min(times['graph']):.3f}-"
            f"{max(times['graph']):.3f}), eager median {statistics.median(times['eager']):.3f} ms "
            f"(runs {min(times['eager']):.3f}-{max(times['eager']):.3f}), 3 runs each in turns "
            f"[{smi}]")


def block_pass(kzg, label: str, smi: str) -> None:
    """One block's blobs, prepared as the block's sidecars, on the Kzg's graphs:
    6 blobs padded to 8 lanes (and 2 and 3 blobs, on 2 and 4 lanes)
    through blobs_to_kzg_commitments, compute_kzg_proofs and
    compute_blob_kzg_proofs, and 6 triples through
    verify_blob_kzg_proof_batch, each output equal to the vendored
    vectors'; Kzg.lanes over the pass (every program runs 8 lanes for 6
    blobs), the size-8 captures' pool bytes, and a 6-blob commit and blob
    proofs timed.  Its launches are no path's."""
    def valid(op):
        d = os.path.join(VECTORS, op)
        cases = [parse_vector(os.path.join(d, name, "data.yaml")) for name in sorted(os.listdir(d))]
        return [c for c in cases if c["output"] is not None and c["output"] is not False]

    commits = valid("blob_to_kzg_commitment")
    proofs_at_z = valid("compute_kzg_proof")
    blob_proofs = valid("compute_blob_kzg_proof")
    triples = [c["input"] for c in valid("verify_blob_kzg_proof")]
    wrong = parse_vector(os.path.join(VECTORS, "verify_blob_kzg_proof", "valid_false_wrong_proof",
                                      "data.yaml"))["input"]

    def pick(cases, n):
        return [cases[i % len(cases)] for i in range(n)]

    before = {k: list(v) for k, v in kzg.lanes.items()}
    for n in (2, 3, 6):
        cs = pick(commits, n)
        if kzg.blobs_to_kzg_commitments([c["input"]["blob"] for c in cs]) != [c["output"] for c in cs]:
            raise AssertionError(f"block pass ({label}): {n} commitments differ from the vectors")
        ps = pick(proofs_at_z, n)
        proofs, ys = kzg.compute_kzg_proofs([c["input"]["blob"] for c in ps],
                                            [c["input"]["z"] for c in ps])
        if [list(p) for p in zip(proofs, ys)] != [c["output"] for c in ps]:
            raise AssertionError(f"block pass ({label}): {n} proofs at z differ from the vectors")
        bs = pick(blob_proofs, n)
        if kzg.compute_blob_kzg_proofs([c["input"]["blob"] for c in bs],
                                       [c["input"]["commitment"] for c in bs]) != [c["output"] for c in bs]:
            raise AssertionError(f"block pass ({label}): {n} blob proofs differ from the vectors")
    block = pick(triples, 6)
    args = [[t[k] for t in block] for k in ("blob", "commitment", "proof")]
    bad = [list(a) for a in args]
    bad[0][4], bad[1][4], bad[2][4] = wrong["blob"], wrong["commitment"], wrong["proof"]
    verdicts = (kzg.verify_blob_kzg_proof_batch(*args), kzg.verify_blob_kzg_proof_batch(*bad))
    if verdicts != (True, False):
        raise AssertionError(f"block pass ({label}): 6-triple verdicts {verdicts}, not (True, False)")
    lanes = {k: [v[0] - before.get(k, [0, 0])[0], v[1] - before.get(k, [0, 0])[1]]
             for k, v in kzg.lanes.items()}
    # 2, 3 and 6 items run on 2, 4 and 8 lanes: 11 given, 14 run a call
    want = {"commit": [11, 14], "prove": [22, 28], "validate_g1": [11, 14], "verify_batch": [12, 16]}
    if lanes != want:
        raise AssertionError(f"block pass ({label}): lanes {lanes}, expected {want}")
    programs = kzg._graphs.programs
    for name in ("commit", "prove", "validate_g1", "verify_batch"):
        x = programs[name].graphs[8]
        parts = (("head", x.head), ("step", x.step), ("tail", x.tail)) if hasattr(x, "step") else (("", x),)
        log(f"block pass ({label}): {name} at 8 lanes: " + "; ".join(
            f"{part + ' ' if part else ''}{g.pool_bytes} bytes allocated, "
            f"{g.pool_reserved_bytes} bytes newly reserved, {g.nodes} nodes" for part, g in parts)
            + f" [{smi}]")
    blobs = [c["input"]["blob"] for c in pick(commits, 6)]
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comms = kzg.blobs_to_kzg_commitments(blobs)
        kzg.compute_blob_kzg_proofs(blobs, comms)
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"block pass ({label}): 2, 3 and 6 blobs committed and proved (at z and as blob proofs) "
        f"and 6 triples verified (True, and False with one wrong proof) as the vectors say; "
        f"lanes given and run over the pass {lanes}; a 6-blob commit and blob proofs "
        f"{statistics.median(times):.3f} ms (median of 5, runs {min(times):.3f}-{max(times):.3f}); "
        f"all graphs' lanes since load {kzg.lanes} [{smi}]")


def main_path(dev, smi: str) -> tuple[dict, dict]:
    """Each path of the port through its public entry points at mainnet
    width; returns the launches per kernel summed over the paths, and
    mont_mul's launches by lane count."""
    from dataclasses import replace

    from kateth_tpu_torch import cuda_lib, host
    from kateth_tpu_torch.curves import compress, decompress
    from kateth_tpu_torch.curves import g2 as g2mod
    from kateth_tpu_torch.kzg import Kzg, KzgError, TorchSetup
    from kateth_tpu_torch.kzg.setup import DEFAULT_TRUSTED_SETUP, FIELDS

    totals = {k: 0 for k in cuda_lib.KERNELS}
    k1_buckets = {k: 0 for k in cuda_lib.MONT_MUL_LAUNCHES}
    holder = {}

    def batch_verify():
        t0 = time.perf_counter()
        kzg = holder["kzg"] = Kzg.load_json(DEFAULT_TRUSTED_SETUP, device=dev)
        torch.cuda.synchronize()
        log(f"main path: load_json {time.perf_counter() - t0:.2f} s")
        run_vectors("verify_blob_kzg_proof_batch",
                    lambda i: kzg.verify_blob_kzg_proof_batch(i["blobs"], i["commitments"], i["proofs"]))
        run_vectors("verify_blob_kzg_proof",
                    lambda i: kzg.verify_blob_kzg_proof(i["blob"], i["commitment"], i["proof"]))
        case = parse_vector(os.path.join(VECTORS, "verify_blob_kzg_proof_batch", "valid_true_4",
                                         "data.yaml"))["input"]
        batch = holder["batch"] = tuple(case[k] * 16 for k in ("blobs", "commitments", "proofs"))
        if kzg.verify_blob_kzg_proof_batches([batch]) != [True]:
            raise AssertionError("64-blob batch did not verify")
        graph = kzg._verify_graphs.graphs[64]
        log(f"graph: batch verify of 64 blobs captured; pool {graph.pool_bytes} bytes allocated, "
            f"{graph.pool_reserved_bytes} bytes reserved; a replay launches "
            f"{graph.launches['launches']} [{smi}]")
        # verify_blob_kzg_proof_batches' loop: every dispatch, then every
        # finalize; only the finalizes read back
        n_batches = 8
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = [kzg._verify_batch_dispatch(*batch) for _ in range(n_batches)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        t_dispatch = time.perf_counter() - t0
        verdicts = [kzg._verify_batch_finalize(p) for p in pending]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if verdicts != [True] * n_batches:
            raise AssertionError(f"streaming verdicts {verdicts}")
        log(f"main path: streaming {n_batches} x 64 blobs in {dt:.3f} s = "
            f"{64 * n_batches / dt:.1f} proofs/s, its {n_batches} dispatches in "
            f"{t_dispatch:.3f} s with no host sync (sync debug mode \"error\") [{smi}]")

    def single_verify():
        kzg = holder["kzg"]
        run_vectors("verify_kzg_proof",
                    lambda i: kzg.verify_kzg_proof(i["proof"], i["commitment"], i["z"], i["y"]))
        graph = kzg._graphs.programs["verify_kzg"].graphs[1]
        log(f"graph: verify_kzg captured at 1 opening, {graph.replays} replays over the vectors; "
            f"pool {graph.pool_bytes} bytes allocated, {graph.pool_reserved_bytes} bytes newly "
            f"reserved; a replay launches {graph.launches['launches']} [{smi}]")

    def commit_comb():
        kzg = holder["kzg"]
        case = parse_vector(os.path.join(VECTORS, "blob_to_kzg_commitment", "valid_0", "data.yaml"))
        blob = case["input"]["blob"]
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if kzg.blob_to_kzg_commitment(blob) != case["output"]:
            raise AssertionError("first commitment differs from the vector")
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        rows = kzg.config.n << kzg.config.comb_h
        log(f"commit: first commit (comb table of {rows} rows built, then the 1-lane commit "
            f"graph captured) {first:.2f} s, peak device memory {peak:.2f} GiB [{smi}]")
        programs = kzg._graphs.programs
        for op, call, names in (
                ("blob_to_kzg_commitment", lambda i: kzg.blob_to_kzg_commitment(i["blob"]), ("commit",)),
                ("compute_kzg_proof", lambda i: kzg.compute_kzg_proof(i["blob"], i["z"]), ("prove",)),
                ("compute_blob_kzg_proof",
                 lambda i: kzg.compute_blob_kzg_proof(i["blob"], i["commitment"]),
                 ("validate_g1", "prove"))):
            before = {k: programs[k].graphs[1].replays if k in programs else 0 for k in names}
            run_vectors(op, call)
            after = {k: programs[k].graphs[1].replays for k in names}
            if any(after[k] <= before[k] for k in names):
                raise AssertionError(f"{op}: the vectors did not replay the 1-lane graphs {names}")
            log(f"graph: {op} vectors replayed " + ", ".join(
                f"{k} {after[k] - before[k]} times" for k in names))
        blobs = [blob] * 64
        kzg.blobs_to_kzg_commitments(blobs)  # captures the 64-lane graph
        times = []
        for _ in range(3):
            k8 = cuda_lib.LAUNCHES["comb_chain_sum"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = kzg.blobs_to_kzg_commitments(blobs)
            times.append(time.perf_counter() - t0)
            if out != [case["output"]] * 64:
                raise AssertionError("64-blob commitments differ from the vector")
            if cuda_lib.LAUNCHES["comb_chain_sum"] - k8 != 1:
                raise AssertionError("a 64-blob commit did not launch K8 exactly once")
        dt = statistics.median(times)
        log(f"commit: 64-blob blobs_to_kzg_commitments {dt:.3f} s (median of 3) = "
            f"{64 / dt:.1f} commitments/s, one K8 launch each [{smi}]")
        for name in ("commit", "prove", "validate_g1"):
            for size, graph in sorted(programs[name].graphs.items()):
                log(f"graph: {name} captured at {size} blobs; pool {graph.pool_bytes} bytes "
                    f"allocated, {graph.pool_reserved_bytes} bytes newly reserved; a replay "
                    f"launches {graph.launches['launches']} [{smi}]")

    def commit_prove_msm():
        base = holder["kzg"]
        kzg = holder["kzg_msm"] = Kzg(replace(base.setup, config=replace(base.config, comb_h=0)))
        programs = kzg._graphs.programs
        for op, call, names in (
                ("blob_to_kzg_commitment", lambda i: kzg.blob_to_kzg_commitment(i["blob"]), ("commit",)),
                ("compute_kzg_proof", lambda i: kzg.compute_kzg_proof(i["blob"], i["z"]), ("prove",)),
                ("compute_blob_kzg_proof",
                 lambda i: kzg.compute_blob_kzg_proof(i["blob"], i["commitment"]),
                 ("validate_g1", "prove"))):
            before = {k: programs[k].graphs[1].replays if k in programs else 0 for k in names}
            run_vectors(op, call)
            after = {k: programs[k].graphs[1].replays for k in names}
            if any(after[k] <= before[k] for k in names):
                raise AssertionError(f"{op} (comb_h = 0): the vectors did not replay the 1-lane "
                                     f"graphs {names}")
            log(f"graph (comb_h = 0): {op} vectors replayed " + ", ".join(
                f"{k} {after[k] - before[k]} times" for k in names))
        for name in ("commit", "prove"):
            scan = programs[name].graphs[1]
            log(f"graph (comb_h = 0): {name} captured at 1 blob as a head, a step replayed "
                f"{scan.length} times a call and a tail; a call launches {scan.launches['launches']}")

    drive("batch verify", batch_verify, totals, k1_buckets)
    graph_against_eager(holder["kzg"], holder["batch"], smi)
    drive("single-point verify", single_verify, totals, k1_buckets)
    drive("commit and prove (comb_h = 12)", commit_comb, totals, k1_buckets)
    path_graphs_against_eager(holder["kzg"], holder["batch"], smi)
    block_pass(holder["kzg"], "comb_h = 12", smi)
    def form_conversion():
        kzg = holder["kzg"]
        d = os.path.join(VECTORS, "blob_to_kzg_commitment")
        cases = [parse_vector(os.path.join(d, name, "data.yaml")) for name in sorted(os.listdir(d))]
        cases = [c for c in cases if c["output"] is not None]
        picks = [cases[i % len(cases)] for i in range(64)]
        blobs = holder["blobs"] = [c["input"]["blob"] for c in picks]
        holder["commitments"] = [c["output"] for c in picks]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coeffs = kzg.blobs_to_coefficients(blobs)
        t1 = time.perf_counter()
        back = kzg.coefficients_to_blobs(coeffs)
        t2 = time.perf_counter()
        if back != blobs:
            raise AssertionError("coefficients_to_blobs(blobs_to_coefficients(blobs)) != blobs")
        n = kzg.config.n
        roots, brp = host.roots_of_unity(n), host.brp_indices(n)
        for b in (0, 1):
            cs = [int.from_bytes(c, "big") for c in coeffs[b]]
            for i in (0, 1, n // 2 + 3, n - 1):
                acc = 0
                for c in reversed(cs):
                    acc = (acc * roots[brp[i]] + c) % host.R
                if acc.to_bytes(32, "big") != blobs[b][32 * i:32 * (i + 1)]:
                    raise AssertionError(f"blob {b}'s coefficients miss its element {i}")
        try:
            kzg.coefficients_to_blobs([coeffs[0][:-1]])
        except KzgError:
            pass
        else:
            raise AssertionError("a wrong coefficient count did not raise")
        log(f"form conversion: 64 blobs, blobs_to_coefficients {t1 - t0:.3f} s, "
            f"coefficients_to_blobs {t2 - t1:.3f} s, round trip and Horner checks pass [{smi}]")

    def setup_load():
        base = holder["kzg"].setup
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        setup = TorchSetup.load_json(DEFAULT_TRUSTED_SETUP, device=dev, cache_dir=None)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        for k in FIELDS:
            if not torch.equal(getattr(setup, k), getattr(base, k)):
                raise AssertionError(f"uncached setup load: {k} differs from the loaded setup")
        with open(DEFAULT_TRUSTED_SETUP) as f:
            obj = json.load(f)
        encs = [bytes.fromhex(h[2:]) for h in obj["g2_monomial"]]
        raw = torch.as_tensor(np.frombuffer(b"".join(encs), dtype=np.uint8).reshape(-1, 96).copy())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt, enc, curve, sub = decompress.g2_decompress(raw.to(dev))
        torch.cuda.synchronize()
        t_g2 = time.perf_counter() - t0
        if not bool((enc & curve & sub).all()):
            raise AssertionError("a mainnet G2 point failed its checks on the card")
        want = g2mod.from_ints([host.g2_decompress(b) for b in encs])
        for got_c, want_c in zip(pt, want):
            if not np.array_equal(got_c.cpu().numpy(), want_c):
                raise AssertionError("the card's G2 points differ from host.g2_decompress")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = compress.g2_points_to_bytes(pt)
        t_comp = time.perf_counter() - t0
        if again != encs:
            raise AssertionError("g2_points_to_bytes does not give back the setup's encodings")
        obj["g2_monomial"][2] = "0x" + twist_point_outside_g2().hex()
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
            bad = os.path.join(tmp, "setup.json")
            with open(bad, "w") as f:
                json.dump(obj, f)
            try:
                TorchSetup.load_json(bad, device=dev, cache_dir=None)
            except KzgError:
                pass
            else:
                raise AssertionError("a G2 point outside the subgroup did not raise")
        log(f"setup load: uncached load_json {t_load:.2f} s, equal to the loaded setup; 65 G2 "
            f"points decoded on the card in {t_g2:.2f} s, equal to host.g2_decompress; "
            f"compressed back in {t_comp:.3f} s; a twist point outside G2 raises [{smi}]")

    def sharding():
        import torch.distributed as dist

        from kateth_tpu_torch import ntt
        from kateth_tpu_torch.curves import msm
        from kateth_tpu_torch.kzg import protocol
        from kateth_tpu_torch.parallel import (
            distributed_init, sharded_commit, sharded_commit_comb, sharded_msm, sharded_ntt_from_brp)

        kzg = holder["kzg"]
        distributed_init(store=dist.HashStore(), rank=0, world_size=1)
        try:
            joined = b"".join(holder["blobs"])
            raw = torch.as_tensor(np.frombuffer(joined, dtype=np.uint8).reshape(64, -1).copy())
            elements, _ = protocol.decode_blobs(raw.to(dev))
            x = protocol.fr_to_mont(elements)

            def timed(fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                return out, time.perf_counter() - t0

            # the first collective also sets up NCCL's communicator
            _, t_first = timed(lambda: sharded_ntt_from_brp(x, inverse=True))
            got, t_ntt = timed(lambda: sharded_ntt_from_brp(x, inverse=True))
            want, t_ntt_ref = timed(lambda: ntt.lagrange_brp_to_monomial(x))
            if not torch.equal(got, want):
                raise AssertionError("sharded_ntt_from_brp != lagrange_brp_to_monomial")
            points = kzg.setup.g1_points
            got, t_msm = timed(lambda: sharded_msm(points, elements[0]))
            want, t_msm_ref = timed(lambda: msm.msm(points, elements[0]))
            if not same_affine(got, want):
                raise AssertionError("sharded_msm != msm.msm in affine")
            got, t_comb = timed(lambda: sharded_commit_comb(kzg._comb_table, elements, kzg.config.comb_h))
            if compress.points_to_bytes(got) != holder["commitments"]:
                raise AssertionError("sharded_commit_comb differs from the vectors' commitments")
            small = tuple(c[:256] for c in points)
            got = sharded_commit(small, elements[:2, :256])
            if not all(torch.equal(a, b) for a, b in zip(got, msm.msm(small, elements[:2, :256]))):
                raise AssertionError("sharded_commit differs from msm.msm")
        finally:
            dist.destroy_process_group()
        log(f"sharding (NCCL, world of 1): sharded_ntt_from_brp of 64 blobs {t_ntt:.3f} s "
            f"(first call {t_first:.3f} s; lagrange_brp_to_monomial {t_ntt_ref:.3f} s), "
            f"sharded_msm of 4096 points {t_msm:.2f} s (msm.msm {t_msm_ref:.2f} s), "
            f"sharded_commit_comb of 64 blobs {t_comb:.3f} s, all equal to the single-device "
            f"results [{smi}]")

    drive("commit and prove (comb_h = 0)", commit_prove_msm, totals, k1_buckets)
    windowed_graphs_against_eager(holder["kzg_msm"], smi)
    block_pass(holder["kzg_msm"], "comb_h = 0", smi)
    for path, fn in (("form conversion", form_conversion), ("setup load (uncached)", setup_load),
                     ("sharding (world of 1)", sharding)):
        t0 = time.perf_counter()
        drive(path, fn, totals, k1_buckets)
        log(f"path {path}: {time.perf_counter() - t0:.2f} s")
    log(f"mont_mul launches by lanes over the seven paths: {k1_buckets}")
    log(f"device memory reserved after all paths: {torch.cuda.memory_reserved(dev)} bytes "
        f"(allocated {torch.cuda.memory_allocated(dev)}) [{smi}]")
    return totals, k1_buckets


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
    launches, k1_buckets = main_path(dev, smi)
    for e in entries:
        e["launches"] = launches[e["name"]]
        if e["name"] == "mont_mul":
            e["launches_by_lanes"] = k1_buckets
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
