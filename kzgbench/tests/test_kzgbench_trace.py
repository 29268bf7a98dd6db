"""The reduction of a traced window (kzgbench/trace.py) and the per-layer
readers on a made-up profile: the union of the device's activity, its
gaps and what the host did in them, the spans less their waits."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from kzgbench import harness, manifest, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(device, name, start_us, end_us):
    return SimpleNamespace(device_type=device, name=name,
                           time_range=SimpleNamespace(start=start_us, end=end_us))


class FakeProfile:
    """Two spans of 100 us; kernels overlapping in the first, a copy and a
    gap spent in a synchronise in the second."""

    def events(self):
        return [
            ev(CPU, trace.SPAN, 0, 100), ev(CPU, trace.SPAN, 120, 220),
            ev(CPU, "cudaGraphLaunch", 1, 5), ev(CPU, "cudaStreamSynchronize", 150, 200),
            ev(CPU, "aten::copy_", 130, 140),
            ev(CUDA, "g1_ladder_kernel(long)", 10, 40), ev(CUDA, "g1_ladder_kernel(long)", 30, 50),
            ev(CUDA, "elementwise_kernel<add>", 50, 60), ev(CUDA, "Memcpy DtoH", 125, 150),
            ev(CUDA, "mont_mul_kernel<Fr>", 200, 201), ev(CUDA, trace.SPAN, 0, 100),
        ]


def test_summary():
    s = trace.summarize(FakeProfile())
    assert s.window_ns == 220_000 and s.span_ns == 200_000
    assert s.device_ops == 5 and s.busy_ns == (60 - 10 + 150 - 125 + 1) * 1000
    assert s.kernel("g1_ladder_kernel") == (2, 50_000)
    assert s.wait_ns(frozenset({"cudaStreamSynchronize", "cudaMemcpyAsync"})) == 50_000
    # a gap is labelled by what the host ran at its start: 0-10, 60-125 and
    # 201-220 start in a span with no host event running, 150-200 in a wait
    gaps = dict(s.breakdown()["idle_gaps"])
    assert gaps == pytest.approx({"Python inside a public call": 94e-6, "cudaStreamSynchronize": 50e-6})


def test_readers():
    s = trace.summarize(FakeProfile())
    ctx = harness.Ctx(calls=[], window_s=0.0, setup_s=1.5, peak_bytes=2**31, trace=s, trace_ops=2,
                      shape={"batch": 64, "n": 4096, "comb_h": 12, "msm_window": 8})

    def read(name):
        spec = manifest.metric(name)
        return manifest.reader(spec.pop("reader")).read(ctx, **spec)

    assert read("host_ms.verify") == pytest.approx((200 - 50) / 2 / 1000)
    assert read("device_ms.verify") == pytest.approx(76 / 2 / 1000)
    assert read("device_ops.verify") == 2.5
    assert read("plain_ms.verify") == pytest.approx(10 / 2 / 1000)
    assert read("idle_share.verify") == pytest.approx(100 * (1 - 76 / 220))
    least = 321 * 256 * 20 * 300 / 8.36352e12
    assert read("k3_roofline.verify") == pytest.approx(100 * least / 25e-6)
    assert read("k8_roofline.submit") is None  # no launch: nothing to read
    assert read("peak_reserved_gib") == 2.0 and read("setup_s") == 1.5
