"""A kernel's share of its roofline, in percent: its least time a launch
over its mean device time a launch in the traced window.  The least time
is the larger of the bytes the algorithm moves over the HBM rate and its
Fp or Fr products, each 2N^2 + N wide multiplies (a schoolbook Montgomery
product of N 32-bit limbs), over the peak wide-multiply rate
(kzgbench/peaks.json).  The work is counted from the algorithm at the
cell's shapes by kzgbench/roofline/<count>.py, never from the port's
schedules."""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def least_seconds(work: dict) -> float:
    with open(os.path.join(HERE, "peaks.json")) as f:
        peaks = json.load(f)
    limbs = work["limbs"]
    muls = work["products"] * (2 * limbs * limbs + limbs)
    return max(work["bytes"] / peaks["hbm_bytes_per_s"]["value"],
               muls / peaks["wide_multiplies_per_s"]["value"])


def load(count: str):
    spec = importlib.util.spec_from_file_location(
        f"kzgbench_roofline_{count}", os.path.join(HERE, "roofline", f"{count}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(ctx, count: str):
    t = ctx.trace
    if t is None:
        return None
    mod = load(count)
    launches, ns = t.kernel(mod.KERNEL)
    if not launches or not ns:
        return None
    return 100 * least_seconds(mod.work(ctx.shape)) / (ns / launches / 1e9)
