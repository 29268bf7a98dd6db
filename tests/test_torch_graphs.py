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

The generic cache (GraphCache, ProgramGraphs) is driven the same way with
several programs sharing one stand-in pool, and so are scan programs
(ScanGraphs: a head, a step replayed once a window, a tail), through a
stand-in for ProgramGraphs._capture_graph, the one method every capture
goes through, so the scans' own capture and replay logic runs here; there
a replay overwrites every output that another graph left in the shared
pool, as its temporaries may.
"""

import contextlib
import threading
import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

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


# --- scan programs: a head, a step replayed once a window, a tail -----------

#: windows of the stand-in scan
W = 5

#: the launches each part of the stand-in scan makes when it runs
SCAN_LAUNCHES = {"head": {"mont_mul": 2}, "step": {"prefix_scan": 1, "mont_mul": 5},
                 "tail": {"pow_chain": 1, "mont_mul": 1}}


def launch(part: str) -> None:
    """Count the stand-in launches of one part, as its kernels' wrappers
    would."""
    for name, v in SCAN_LAUNCHES[part].items():
        cuda_lib.LAUNCHES[name] += v


def launch_diff(before, after):
    return {k: {n: after[k][n] - before[k][n] for n in after[k]} for k in after}


def make_scan(log):
    """A protocol.Scan whose result depends on the order of its steps (a
    Horner sum of the windows) and whose parts log each call; window w's x
    holds w in its thousands."""
    from kateth_tpu_torch.kzg import protocol

    def head(a):
        log.append(("head",))
        launch("head")
        xs = torch.arange(W)[:, None] * 1000 + a[:, :W].T
        return (a[:, 0] * 0, a[:, 1] * 0 + 1), xs, (a.sum(-1),)

    def step(carry, x):
        log.append(("step", int(x[0]) // 1000))
        launch("step")
        return carry[0] * 3 + x, carry[1] * 2 + x % 7

    def tail(carry, s):
        log.append(("tail",))
        launch("tail")
        return carry[0] + carry[1], s

    return protocol.Scan(head, step, tail)


class ScratchGraph:
    """Stands in for a captured graph of fn whose outputs pass through a
    memory pool shared by every graph of the cache (`scratch`): a replay
    first overwrites (bitwise not) every output that another graph left in
    the pool (`pool_outputs`: the outputs its capture made rather than
    static buffers), as a replay's temporaries may take those blocks;
    then it runs fn on the static inputs (taking back out the launches its
    Python wrappers count, as a replay runs none of them), writes the
    outputs to the scratch, sleeps, and copies what the scratch then holds
    into the static outputs.  Two replays that overlapped would give each
    other's values, and an output in the pool read after another graph's
    replay would be wrong."""

    def __init__(self, fn, inputs, outputs, scratch, pool_outputs):
        self.fn, self.inputs, self.outputs, self.scratch = fn, inputs, outputs, scratch
        self.pool_outputs = pool_outputs

    def replay(self) -> None:
        for graph, outs in self.pool_outputs:
            if graph is not self:
                for out in outs:
                    out.bitwise_not_()
        before = cuda_lib.launch_counts()
        values = self.fn(*self.inputs)
        cuda_lib.add_launch_counts(launch_diff(before, cuda_lib.launch_counts()), -1)
        flat = torch.cat([v.reshape(-1).to(torch.int64) for v in values])
        self.scratch[:flat.numel()] = flat
        time.sleep(0.002)
        o = 0
        for out in self.outputs:
            out.copy_(self.scratch[o:o + out.numel()].reshape(out.shape).to(out.dtype))
            o += out.numel()


class NewStorages(TorchDispatchMode):
    """Records the storages of the tensors that operations return in new
    memory (not a view of or an in-place result on one of their inputs)."""

    def __init__(self):
        super().__init__()
        self.made = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        given = {t.untyped_storage().data_ptr() for t in tree_leaves((args, kwargs))
                 if isinstance(t, torch.Tensor)}
        self.made.update(t.untyped_storage().data_ptr() for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor)
                         and t.untyped_storage().data_ptr() not in given)
        return out


@pytest.fixture
def scratch_capture(monkeypatch):
    """ProgramGraphs._capture_graph (every graph a ProgramGraphs or a
    ScanGraphs captures) replaced by one that runs fn once, as a capture
    records it, takes its launches back out as a capture does, and makes a
    ScratchGraph over one scratch buffer for the whole process; the
    outputs that fn made (not static buffers it wrote) are the graph's
    outputs in the pool."""
    scratch = torch.zeros(1 << 16, dtype=torch.int64)
    pool_outputs = []

    def capture_graph(self, fn, static_inputs):
        before = cuda_lib.launch_counts()
        with NewStorages() as mode:
            outputs = tuple(fn(*static_inputs))
        launches = launch_diff(before, cuda_lib.launch_counts())
        cuda_lib.add_launch_counts(launches, -1)
        graph = ScratchGraph(fn, list(static_inputs), outputs, scratch, pool_outputs)
        pool_outputs.append((graph, [o for o in outputs
                                     if o.untyped_storage().data_ptr() in mode.made]))
        return graphs.CapturedBatch(graph, list(static_inputs), outputs, launches, 0, 0)

    monkeypatch.setattr(graphs.ProgramGraphs, "_capture_graph", capture_graph)


def test_scan_replays_its_step_in_order(fake_cuda, scratch_capture):
    """A scan program's call: the cache's stream waits for the caller's,
    the head's graph replays, the step's W times in window order, then the
    tail's, and the caller's stream waits for the cache's; the result is the
    eager scan's, and the call adds the head's launches, W times the
    step's and the tail's."""
    log = fake_cuda
    cache = make_cache(log)
    scan = make_scan(log)
    prog = cache.program("commit", scan)
    assert isinstance(prog, graphs.ScanGraphs)
    me = f"caller {threading.current_thread().name}"
    a, b = batch(7)
    prog((a,))  # captures
    want = scan(b)
    log.clear()
    before = cuda_lib.launch_counts()
    got = prog((b,))
    after = cuda_lib.launch_counts()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert log == [("graphs", "waits for", me), ("head",), *(("step", w) for w in range(W)),
                   ("tail",), (me, "waits for", "graphs")]
    want_launches = {}
    for part, times in (("head", 1), ("step", W), ("tail", 1)):
        for name, v in SCAN_LAUNCHES[part].items():
            want_launches[name] = want_launches.get(name, 0) + times * v
    assert launch_diff(before, after)["launches"] == {
        name: want_launches.get(name, 0) for name in cuda_lib.LAUNCHES}
    captured = prog.graphs[4]
    assert captured.length == W and captured.launches["launches"]["prefix_scan"] == W
    assert (captured.replays, captured.head.replays, captured.step.replays,
            captured.tail.replays) == (2, 2, 2 * W, 2)


def test_scan_and_program_threads_get_their_own_results(fake_cuda, scratch_capture):
    """Four threads on one cache, two in a scan program and two in a
    plain one: the shared scratch would mix values if a step, head or tail
    replay overlapped another program's replay, so each thread getting its
    own results shows that a whole scan call holds the one lock."""
    cache = make_cache(fake_cuda)
    scan = make_scan([])
    commit = cache.program("commit", scan)
    verify = cache.program("verify", verify_like)
    failures = []

    def worker(k: int):
        for i in range(8):
            a, b = batch(100 * k + i)
            if k % 2:
                got, want = commit((a,)), scan(a)
            else:
                got, want = verify((a, b)), verify_like(a, b)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                failures.append((k, i))

    threads = [threading.Thread(target=worker, args=(k,), name=f"t{k}") for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert failures == []
    assert list(commit.graphs) == [4] and list(verify.graphs) == [4]


def test_windowed_kzg_runs_commit_and_prove_through_the_cache(fake_cuda, scratch_capture,
                                                               monkeypatch):
    """A Kzg at comb_h = 0 whose graph cache stands in for a CUDA device's
    sends blobs_to_kzg_commitments and compute_kzg_proofs through scan
    programs of its cache, never runs a program eagerly, and gets what an
    eager Kzg (the CPU's) gets.  A stand-in window step (a doubling and the
    addition of one setup point a window), a K2 stand-in and a setup of
    random digit planes keep it cheap: only the routing is at stake here;
    the eager Kzg runs the same."""
    import numpy as np

    from kateth_tpu_torch import host
    from kateth_tpu_torch.curves import msm, ops
    from kateth_tpu_torch.fields import cuda_mont
    from kateth_tpu_torch.fields import limbs as L
    from kateth_tpu_torch.fields.specs import FP, FR
    from kateth_tpu_torch.kzg import Kzg, KzgConfig, TorchSetup, protocol

    def step_stand_in(points, acc, dig, c):
        F = ops.FP_FIELD
        return ops.padd(F, ops.pdouble(F, acc), tuple(p[dig[..., 0] % p.shape[0]] for p in points))

    monkeypatch.setattr(msm, "window_step", step_stand_in)
    monkeypatch.setattr(cuda_mont, "pow_const", lambda spec, a, e: L.add(spec, a, a))
    n = 8
    rng = np.random.default_rng(0x5CA7)

    def planes(rows, spec):
        d = rng.integers(0, 1 << 16, (rows, spec.n_digits))
        d[:, -1] %= int(spec.mod_digits[-1])
        return d

    setup = TorchSetup.from_arrays(
        [planes(n, FP) for _ in range(3)] + [planes(2, FP) for _ in range(3)]
        + [planes(n, FR), planes(n, FR)], KzgConfig(n=n, g2_len=2, canon_batch=4, comb_h=0), "cpu")
    scalars = [int(v) % host.R for v in rng.integers(0, 1 << 62, 4 * n)]
    blobs = [b"".join(v.to_bytes(32, "big") for v in scalars[i * n:(i + 1) * n]) for i in range(3)]
    zs = [v.to_bytes(32, "big") for v in scalars[3 * n:3 * n + 3]]

    def run(kzg):
        return kzg.blobs_to_kzg_commitments(blobs), kzg.compute_kzg_proofs(blobs, zs)

    want = run(Kzg(setup))
    kzg = Kzg(setup)
    kzg._graphs = make_cache(fake_cuda)

    def refuse(*_, **__):
        raise AssertionError("a program ran eagerly")

    for owner, name in ((protocol.Scan, "__call__"), (protocol, "commit_chunk"),
                        (protocol, "prove_chunk"), (msm, "msm")):
        monkeypatch.setattr(owner, name, refuse)
    assert run(kzg) == want
    programs = kzg._graphs.programs
    assert sorted(programs) == ["commit", "prove"]
    for name in ("commit", "prove"):
        assert isinstance(programs[name], graphs.ScanGraphs)
        captured = programs[name].graphs[4]  # 3 blobs: one chunk of 4
        # one step graph, shared: 32 windows of the commit, 32 of the proof
        assert captured.replays == 1 and captured.step.replays == 64
    step = programs["commit"].graphs[4].step
    assert programs["prove"].graphs[4].step is step
    # another batch size captures a step of its own
    assert kzg.blobs_to_kzg_commitments(blobs[:1]) == want[0][:1]
    other = programs["commit"].graphs[1].step
    assert other is not step and other.replays == 32 and step.replays == 64
    assert sorted(kzg._graphs.steps.items(), key=lambda kv: kv[0][1]) == [
        (("msm.window_step c=8", 1), other), (("msm.window_step c=8", 4), step)]
