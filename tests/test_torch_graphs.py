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


# --- the generic cache: several programs of one Kzg ---------------------------

class PoolGraph:
    """Stands in for a captured graph of `fn` whose temporaries live in a
    memory pool shared with other graphs (`scratch`): a replay writes its
    inputs' values to the scratch, sleeps, then computes its outputs from
    what the scratch holds.  Two replays that overlapped would read each
    other's values."""

    def __init__(self, fn, inputs, outputs, scratch, log):
        self.fn, self.inputs, self.outputs, self.scratch, self.log = fn, inputs, outputs, scratch, log

    def replay(self) -> None:
        self.log.append(("replay", self.fn.__name__, self.inputs[0].shape[0]))
        n = self.inputs[0].numel()
        self.scratch[:n] = self.inputs[0].reshape(-1)
        time.sleep(0.002)
        a = self.scratch[:n].reshape(self.inputs[0].shape).clone()
        for out, value in zip(self.outputs, self.fn(a, *self.inputs[1:])):
            out.copy_(value)


def commit_like(a):
    return (a.sum(-1), a * 3)


def verify_like(a, b):
    return (a.sum() - b.sum(), torch.stack([a, b]) + 1)


#: the launches one replay of each program stands for
PROGRAM_LAUNCHES = {
    "commit_like": {"launches": {"mont_mul": 5, "comb_chain_sum": 1}, "mont_mul_lanes": {"<=1024": 5}},
    "verify_like": {"launches": {"g1_ladder": 1, "g2_ladder": 1}, "mont_mul_lanes": {}},
}


@pytest.fixture
def pool_capture(monkeypatch):
    """ProgramGraphs' capture replaced by one that makes a PoolGraph over
    one scratch buffer for the whole process (the shared pool)."""
    scratch = torch.zeros(4096, dtype=torch.int64)

    def capture(self, inputs, caller):
        self.captures = getattr(self, "captures", 0) + 1
        static = [torch.empty_like(t) for t in inputs]
        outputs = tuple(torch.zeros_like(v) for v in self.fn(*inputs))
        graph = PoolGraph(self.fn, static, outputs, scratch, self.cache.log)
        return graphs.CapturedBatch(graph, static, outputs, PROGRAM_LAUNCHES[self.fn.__name__], 0, 0)

    monkeypatch.setattr(graphs.ProgramGraphs, "_capture", capture)


def make_cache(log) -> graphs.GraphCache:
    cache = graphs.GraphCache("cpu")
    cache.log = log
    return cache


def test_programs_share_the_lock_and_pool(fake_cuda, pool_capture):
    """Two threads, one running a commit-like program and one a
    verify-like one on the same cache: replays that overlapped would mix
    the shared pool's values, so each thread getting its own results shows
    that all programs' replays are serialised under the one lock."""
    cache = make_cache(fake_cuda)
    commit = cache.program("commit", commit_like)
    verify = cache.program("verify", verify_like)
    assert cache.program("commit", verify_like) is commit  # taken at first use
    failures = []

    def worker(k: int):
        for i in range(12):
            a, b = batch(100 * k + i)
            if k % 2:
                got, want = commit((a,)), commit_like(a)
            else:
                got, want = verify((a, b)), verify_like(a, b)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                failures.append((k, i))

    threads = [threading.Thread(target=worker, args=(k,), name=f"t{k}") for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert failures == []
    assert sorted(cache.programs) == ["commit", "verify"]
    assert commit.captures == 1 and verify.captures == 1


def test_programs_stream_order_and_launch_counts(fake_cuda, pool_capture):
    """Every program of a cache runs on the cache's one stream, ordered
    after the caller's current stream and before its next work, and each
    replay adds its own capture's launches; batch verify's graphs join the
    same cache under the name verify_batch."""
    log = fake_cuda
    cache = make_cache(log)
    vb = graphs.VerifyBatchGraphs(torch.zeros(4, 16, dtype=torch.int64), (), cache)
    assert cache.programs == {"verify_batch": vb} and vb.cache is cache
    commit = cache.program("commit", commit_like)
    verify = cache.program("verify", verify_like)
    before = cuda_lib.launch_counts()
    me = f"caller {threading.current_thread().name}"
    a, b = batch(1)
    commit((a,))
    other = FakeStream("other", log)
    with torch.cuda.stream(other):
        got = verify((a, b))
    commit((batch(2, nc=8)[0],))
    assert all(torch.equal(x, y) for x, y in zip(got, verify_like(a, b)))
    assert log == [
        ("graphs", "waits for", me), ("replay", "commit_like", 4), (me, "waits for", "graphs"),
        ("graphs", "waits for", "other"), ("replay", "verify_like", 4),
        ("other", "waits for", "graphs"),
        ("graphs", "waits for", me), ("replay", "commit_like", 8), (me, "waits for", "graphs"),
    ]
    after = cuda_lib.launch_counts()
    want = {}
    for name, reps in (("commit_like", 2), ("verify_like", 1)):
        for kind, counts in PROGRAM_LAUNCHES[name].items():
            for k, v in counts.items():
                want[kind, k] = want.get((kind, k), 0) + reps * v
    for (kind, k), v in want.items():
        assert after[kind][k] - before[kind][k] == v
    assert sorted(commit.graphs) == [4, 8] and list(verify.graphs) == [4]
    assert [c.replays for c in (commit.graphs[4], commit.graphs[8], verify.graphs[4])] == [1, 1, 1]


def test_replay_refuses_inputs_that_do_not_fit(fake_cuda, pool_capture):
    """A replay copies into the graph's static inputs, so an input of
    another shape or dtype at the same batch size raises instead of
    broadcasting into them."""
    cache = make_cache(fake_cuda)
    verify = cache.program("verify", verify_like)
    a, b = batch(3)
    verify((a, b))
    with pytest.raises(ValueError, match="does not fit"):
        verify((a, b[:, :4]))
    with pytest.raises(ValueError, match="does not fit"):
        verify((a, b.to(torch.int32)))
