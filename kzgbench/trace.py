"""A traced window's profile, reduced in memory to what the per-layer
readers take: the device's activity (kernels, copies and sets) and its
union, the benchmark's spans around each public call, the blocking CUDA
runtime waits inside them, and the idle gaps with what the host did.

The benchmark's spans are torch.profiler.record_function ranges named
SPAN, so they share the profiler's clock with the device's activity.
No chrome trace is written: a windowed commit alone runs about 460,000
device operations."""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

SPAN = "kzgbench.call"
#: gaps shorter than this are counted together, unlabelled
SHORT_GAP_NS = 5_000


@contextlib.contextmanager
def profiled(cuda: bool):
    """A torch.profiler session over the host and, with cuda, the device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof


def span():
    """The benchmark's host span around one public call."""
    import torch

    return torch.profiler.record_function(SPAN)


@dataclass
class Summary:
    window_ns: int = 0
    busy_ns: int = 0
    device_ops: int = 0
    #: kernel or copy name -> [launches, device ns]
    by_name: dict = field(default_factory=dict)
    span_ns: int = 0
    #: host event name -> ns of those events that start inside a span
    in_spans: dict = field(default_factory=dict)
    #: what the host did -> ns of idle device time
    idle_by_host: dict = field(default_factory=dict)

    def wait_ns(self, waits: frozenset[str]) -> int:
        """ns of the host events named in waits (the blocking CUDA runtime
        calls) inside the spans."""
        return sum(ns for name, ns in self.in_spans.items() if name in waits)

    def kernel(self, needle: str) -> tuple[int, int]:
        """(launches, device ns) of the kernels whose name holds needle."""
        hits = [v for k, v in self.by_name.items() if needle in k]
        return sum(h[0] for h in hits), sum(h[1] for h in hits)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], v[1] / 1e9] for k, v in ops],
                "idle_gaps": [[k[:160], v / 1e9] for k, v in gaps]}


def _events(prof):
    """(device, name, start ns, end ns) of every event, from the profiler's
    raw results where this PyTorch has them (no per-event Python objects
    for a million kernels), else from its parsed events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None and hasattr(raw, "events"):
        for e in raw.events():
            if getattr(e, "is_user_annotation", lambda: False)() and e.device_type() == cuda:
                continue  # a span's copy on the device's timeline
            start = e.start_ns()
            yield e.device_type() == cuda, e.name(), start, start + e.duration_ns()
        return
    for e in prof.events():
        start = int(e.time_range.start * 1000)
        yield e.device_type == cuda, e.name, start, int(e.time_range.end * 1000)


def summarize(prof) -> Summary:
    device, cpu, spans = [], [], []
    for on_device, name, start, end in _events(prof):
        if on_device:
            if name != SPAN:
                device.append((start, end, name))
        elif name == SPAN:
            spans.append((start, end))
        else:
            cpu.append((start, end, name))
    out = Summary()
    if not spans:
        return out
    lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    out.window_ns = hi - lo
    out.span_ns = sum(e - s for s, e in spans)
    spans.sort()
    starts = [s for s, _ in spans]

    def in_span(t: int) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and spans[i][1] >= t

    for s, e, name in cpu:
        if in_span(s):
            out.in_spans[name] = out.in_spans.get(name, 0) + e - s
    device.sort()
    for s, e, name in device:
        if e <= lo or s >= hi:
            continue
        entry = out.by_name.setdefault(name, [0, 0])
        entry[0] += 1
        entry[1] += e - s
        out.device_ops += 1
    # union of the device's activity within the window, and its gaps
    gaps, cur_s, cur_e = [], lo, lo
    for s, e, _ in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur_e:
            out.busy_ns += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s = s
        cur_e = max(cur_e, e)
    out.busy_ns += cur_e - cur_s
    if cur_e < hi:
        gaps.append((cur_e, hi))
    cpu.sort()
    cpu_starts = [s for s, _, _ in cpu]
    for s, e in gaps:
        label = "gaps under 5 us" if e - s < SHORT_GAP_NS else _host_at(cpu, cpu_starts, s, in_span)
        out.idle_by_host[label] = out.idle_by_host.get(label, 0) + e - s
    return out


def _host_at(cpu, starts, t: int, in_span, look_back: int = 256) -> str:
    """The innermost host event running at t (the latest started of those
    that cover it), else whether the host ran Python inside a public call
    or between calls."""
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(cpu[max(0, i - look_back):i]):
        if e >= t:
            return name
    return "Python inside a public call" if in_span(t) else "Python between calls"
