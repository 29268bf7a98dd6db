"""graphs.VerifyBatchGraphs' dispatch, on the CPU, with stand-ins for the
CUDA graph and the CUDA streams.

A replay reads the graph's static inputs and writes its static outputs, so
each call's copies in, replay and copies out must run with no other call in
between, on the graphs' own stream, ordered after the caller's current
stream and before the caller's next work.  The stand-in graph sleeps
between the copies in and its read of the inputs, so two threads that
share the graphs would mix up their batches if the calls interleaved.  The
stand-in streams record every wait and every replay in order.  Every value
is an integer: the tolerance is exact equality.
"""

import contextlib
import threading
import time

import pytest
import torch

from kateth_tpu_torch import cuda_lib, graphs


class FakeStream:
    """Records its waits in the shared log."""

    def __init__(self, name: str, log: list):
        self.name, self.log = name, log

    def wait_stream(self, other: "FakeStream") -> None:
        self.log.append((self.name, "waits for", other.name))


class FakeGraph:
    """Stands in for a captured CUDAGraph of `program`: a replay sleeps,
    then reads the static inputs, then writes the static outputs."""

    def __init__(self, inputs, outputs, log):
        self.inputs, self.outputs, self.log = inputs, outputs, log

    def replay(self) -> None:
        self.log.append(("replay", self.inputs[0].shape[0]))
        time.sleep(0.002)
        for out, value in zip(self.outputs, program(*self.inputs)):
            out.copy_(value)


def program(a, b):
    """What the stand-in graph computes: a verdict and a plane of its
    inputs, as verify_blob_batch gives (verdict, packed masks)."""
    return (a.sum() * 1000 + b.sum()), torch.stack([a, b]) * 2


#: the launches one replay stands for
LAUNCHES = {"launches": {"mont_mul": 3, "pow_chain": 1}, "mont_mul_lanes": {"<=1024": 3}}


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's streams replaced by FakeStreams that log to one list;
    each thread's current stream starts as its own 'caller <thread>'."""
    log, local = [], threading.local()

    def current_stream(device=None):
        if not hasattr(local, "stream"):
            local.stream = FakeStream(f"caller {threading.current_thread().name}", log)
        return local.stream

    @contextlib.contextmanager
    def stream(s):
        prev = current_stream()
        local.stream = s
        try:
            yield
        finally:
            local.stream = prev

    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: FakeStream("graphs", log))
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "stream", stream)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    return log


class StandInGraphs(graphs.VerifyBatchGraphs):
    """VerifyBatchGraphs whose capture makes a FakeGraph."""

    def _capture(self, inputs, caller):
        self.captures = getattr(self, "captures", 0) + 1
        static = [torch.empty_like(t) for t in inputs]
        outputs = tuple(torch.zeros_like(v) for v in program(*inputs))
        return graphs.CapturedBatch(FakeGraph(static, outputs, self.log), static, outputs,
                                    LAUNCHES, 0, 0)


def make_graphs(log) -> StandInGraphs:
    g = StandInGraphs(torch.zeros(4, 16, dtype=torch.int64), ())
    g.log = log
    return g


def batch(seed: int, nc: int = 4):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 1000, (nc, 8), generator=gen) for _ in range(2)]


def test_threads_sharing_graphs_get_their_own_results(fake_cuda):
    g = make_graphs(fake_cuda)
    failures = []

    def worker(k: int):
        for i in range(12):
            inputs = batch(100 * k + i)
            got = g(inputs)
            want = program(*inputs)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                failures.append((k, i))

    threads = [threading.Thread(target=worker, args=(k,), name=f"t{k}") for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert failures == []
    assert g.captures == 1 and list(g.graphs) == [4]


def test_stream_order_and_launch_counts(fake_cuda):
    """Each call: the graphs' stream waits for the caller's current stream,
    the replay, then the caller's stream waits for the graphs' stream; a
    caller that changes its current stream is waited for on the new one.
    Each replay adds the capture's launches; a new padded size captures a
    graph of its own."""
    log = fake_cuda
    g = make_graphs(log)
    before = cuda_lib.launch_counts()
    me = f"caller {threading.current_thread().name}"
    g(batch(1))
    other = FakeStream("other", log)
    with torch.cuda.stream(other):
        got = g(batch(2))
    g(batch(3, nc=8))
    assert all(torch.equal(x, y) for x, y in zip(got, program(*batch(2))))
    assert log == [
        ("graphs", "waits for", me), ("replay", 4), (me, "waits for", "graphs"),
        ("graphs", "waits for", "other"), ("replay", 4), ("other", "waits for", "graphs"),
        ("graphs", "waits for", me), ("replay", 8), (me, "waits for", "graphs"),
    ]
    after = cuda_lib.launch_counts()
    for kind, counts in LAUNCHES.items():
        for name, v in counts.items():
            assert after[kind][name] - before[kind][name] == 3 * v
    assert g.captures == 2 and sorted(g.graphs) == [4, 8]
