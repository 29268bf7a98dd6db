"""The port's device programs as captured CUDA graphs: its counterpart of the
JAX package's `@jax.jit` programs (kateth_tpu/kzg/protocol.py: batch verify
at :279 with pairing_check at :201, verify_kzg_bytes at :218, commit_comb at
:169, commit_msm at :160, evaluate, quotient and the form conversions at
:77, :127, :370 and :375; kateth_tpu/curves/compress.py:41 and :68).

Each program of kzg/protocol.py that a Kzg runs on the card (batch verify,
single-point verify, the comb commit, the proof and the point validation)
is a fixed sequence of device operations for each batch size: no operation
in it reads a tensor back to the host, every constant it uses is already on
the device, and its kernels launch on the current stream.  So each is
captured once per (Kzg, program, batch size) and replayed for every call of
that size.  A replay is one host call that enqueues the whole program.

The windowed commit and proof (comb_h = 0) are protocol.Scan programs, as
the JAX package runs commit_msm: one compiled window step looped by
lax.scan (kateth_tpu/curves/msm.py:254-266).  A ScanGraphs captures the
Scan's head, its step and its tail as three graphs and replays the step
once a window, so a graph holds one window's operations and the pool one
window's working set, not all W windows'.  Between step replays, copies
on the cache's stream move the step's output carry into its static input
and the next window's digits into its static x; nothing reads back to the
host.  The commit and the proof loop the same step over the same points,
so the cache captures a named step once per batch size and their scans
share it (GraphCache.steps).  The head's outputs, which must outlive the
step replays, go to static buffers outside the pool.

A `GraphCache` holds every graph of one Kzg: one lock, one stream and one
memory pool for all its programs.  A replay reads its graph's static input
buffers and writes the same output tensors each time, so each call's copies
in, replay and copies out run under the lock, on the cache's stream: that
stream waits for the caller's current stream before the copies in, and the
caller's stream waits for it after the copies out.  Threads may share a
Kzg, one committing while another verifies, and a caller may change its
current stream between calls.  All graphs share the pool: their replays
never overlap, and every output a graph leaves in the pool is copied out
(or into a step's static inputs) before the next replay of any graph
starts, since that replay's temporaries may reuse its blocks.

A program in the cache must stay free of host syncs and of uploads (no
`bool(t)`, `.item()`, `.cpu()`, boolean-mask indexing or
`torch.as_tensor(...).to(dev)`): constants go through
`limbs.DeviceConstants`, host data through `protocol.to_device`.

A failed capture or replay raises; there is no eager fallback on CUDA.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass

import torch

from . import cuda_lib
from .kzg import protocol


@dataclass
class CapturedBatch:
    """One captured graph of one program at one batch size: its static
    inputs and outputs, the launches of one replay (a
    cuda_lib.launch_counts() difference), the device memory its capture
    took from the caching allocator (`pool_bytes` left allocated: the
    outputs, the pool's other blocks being free between replays; and
    `pool_reserved_bytes` newly reserved for the shared pool), the number
    of replays so far and the graph's number of nodes."""

    graph: torch.cuda.CUDAGraph
    inputs: list
    outputs: tuple
    launches: dict
    pool_bytes: int
    pool_reserved_bytes: int
    replays: int = 0
    nodes: int = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1


@dataclass
class CapturedScan:
    """One captured protocol.Scan at one batch size: the head's graph
    (outputs, static buffers outside the pool: the carry's tensors, xs,
    then the extras), the step's
    (inputs: the carry's static tensors, then the static x; outputs: the
    next carry) and the tail's (inputs: the carry's static tensors, then
    the head's extras).  `inputs` and `outputs` are the program's.  The
    step may be shared with other scans of the cache (GraphCache.steps):
    its static carry and x are then theirs too, which is safe because every
    replay copies its own carry and x into them under the cache's lock."""

    head: CapturedBatch
    step: CapturedBatch
    tail: CapturedBatch
    replays: int = 0

    @property
    def inputs(self) -> list:
        return self.head.inputs

    @property
    def outputs(self) -> tuple:
        return self.tail.outputs

    @property
    def length(self) -> int:
        """The number of step replays a call: xs's leading size."""
        return self.head.outputs[len(self.step.outputs)].shape[0]

    @property
    def launches(self) -> dict:
        """The launches of one call: the head's, `length` times the
        step's and the tail's."""
        out = {}
        for part, times in ((self.head, 1), (self.step, self.length), (self.tail, 1)):
            for kind, counts in part.launches.items():
                for name, v in counts.items():
                    out.setdefault(kind, {})[name] = out.get(kind, {}).get(name, 0) + times * v
        return out

    def replay(self) -> None:
        """The head, then a step a window, then the tail, all on the
        current stream: before each step the carry and that window's x are
        copied into the step's static inputs."""
        k = len(self.step.outputs)
        carry, xs = self.head.outputs[:k], self.head.outputs[k]
        statics, x = self.step.inputs[:k], self.step.inputs[k]
        self.head.replay()
        for w in range(xs.shape[0]):
            for static, c in zip(statics, carry):
                static.copy_(c, non_blocking=True)
            x.copy_(xs[w], non_blocking=True)
            self.step.replay()
            carry = self.step.outputs
        for static, c in zip(statics, carry):
            static.copy_(c, non_blocking=True)
        self.tail.replay()
        self.replays += 1


class GraphCache:
    """The graphs of one Kzg on one CUDA device, by program name
    (`programs`) and, within a program, by batch size; and the step graphs
    that scans share, by step name and batch size (`steps`)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.programs: dict[str, ProgramGraphs] = {}
        self.steps: dict[tuple[str, int], CapturedBatch] = {}
        self.lock = threading.Lock()
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()

    def program(self, name: str, fn, held=()) -> "ProgramGraphs":
        """The graphs of program `name`: fn(*inputs), a function of tensors
        that returns a tuple of tensors, or a protocol.Scan (ScanGraphs).
        `held` are the setup tensors fn reads by address; the cache keeps
        them.  fn and held are taken at the first use of `name`."""
        with self.lock:
            graphs = self.programs.get(name)
            if graphs is None:
                kind = ScanGraphs if isinstance(fn, protocol.Scan) else ProgramGraphs
                graphs = self.programs[name] = kind(self, fn, held)
        return graphs


class ProgramGraphs:
    """One program of a GraphCache, one graph per batch size (`graphs`,
    keyed by the leading size of the first input, which fixes every
    input's shape for one setup)."""

    def __init__(self, cache: GraphCache, fn, held=()):
        self.cache, self.fn, self.held = cache, fn, held
        self.device = cache.device
        self.graphs: dict[int, CapturedBatch] = {}

    def __call__(self, inputs):
        """Run the program on `inputs` (tensors on the cache's device): the
        replay of its batch size's graph, captured at the first call of
        that size.  Returns the outputs as the caller's own tensors, not
        yet read back; nothing here waits for the device."""
        cache = self.cache
        caller = torch.cuda.current_stream(self.device)
        with cache.lock:
            nc = inputs[0].shape[0]
            captured = self.graphs.get(nc)
            if captured is None:
                captured = self.graphs[nc] = self._capture(inputs, caller)
            for static, t in zip(captured.inputs, inputs):
                if static.shape != t.shape or static.dtype != t.dtype:
                    raise ValueError(f"input {tuple(t.shape)} {t.dtype} does not fit the graph's "
                                     f"{tuple(static.shape)} {static.dtype}")
            outputs = [torch.empty_like(o) for o in captured.outputs]  # on the caller's stream
            cache.stream.wait_stream(caller)
            with torch.cuda.stream(cache.stream):
                for static, t in zip(captured.inputs, inputs):
                    static.copy_(t, non_blocking=True)
                captured.replay()
                for out, o in zip(outputs, captured.outputs):
                    out.copy_(o, non_blocking=True)
            caller.wait_stream(cache.stream)
            cuda_lib.add_launch_counts(captured.launches)
        return tuple(outputs)

    def _static_inputs(self, inputs, caller) -> list:
        """Fresh static buffers holding `inputs`, copied on the cache's
        stream after the caller's work."""
        static_inputs = [torch.empty_like(t) for t in inputs]
        self.cache.stream.wait_stream(caller)
        with torch.cuda.stream(self.cache.stream):
            for static, t in zip(static_inputs, inputs):
                static.copy_(t, non_blocking=True)
        return static_inputs

    def _capture(self, inputs, caller) -> CapturedBatch:
        """Capture for the shapes of `inputs`.  The inputs are copied into
        fresh static buffers and the program runs once on them eagerly on
        the cache's stream before the capture: that builds the kernels, puts
        every constant on the device and sets up cuBLAS for the stream.
        Those launches are counted; the capture's are not."""
        static_inputs = self._static_inputs(inputs, caller)
        with torch.cuda.stream(self.cache.stream):
            self.fn(*static_inputs)
        captured = self._capture_graph(self.fn, static_inputs)
        caller.wait_stream(self.cache.stream)
        return captured

    def _capture_graph(self, fn, static_inputs) -> CapturedBatch:
        """fn(*static_inputs) captured as one graph on the cache's stream,
        into the cache's pool; its launches are recorded, not counted."""
        dev, stream = self.device, self.cache.stream
        before = cuda_lib.launch_counts()
        # torch.cuda.graph empties the allocator's cache before it captures;
        # do it first, so that the reserved bytes after the capture differ
        # from these by what the capture added to the pool alone
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        allocated, reserved = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        # keep_graph: the node count is read from the graph before it is
        # instantiated
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # thread_local: another thread's host prefix (pinned buffers,
        # copies on its own stream) may run while this thread captures
        with torch.cuda.graph(graph, pool=self.cache.pool, stream=stream,
                              capture_error_mode="thread_local"):
            outputs = tuple(fn(*static_inputs))
        graph.instantiate()
        after = cuda_lib.launch_counts()
        launches = {k: {name: after[k][name] - before[k][name] for name in after[k]} for k in after}
        cuda_lib.add_launch_counts(launches, -1)  # recorded, not launched
        return CapturedBatch(graph, static_inputs, outputs, launches,
                             torch.cuda.memory_allocated(dev) - allocated,
                             torch.cuda.memory_reserved(dev) - reserved,
                             nodes=cuda_lib.graph_nodes(graph.raw_cuda_graph()))


class ScanGraphs(ProgramGraphs):
    """A protocol.Scan program of a GraphCache, one CapturedScan per batch
    size: its head, step and tail each captured once, the step replayed
    once a window (CapturedScan.replay)."""

    def _capture(self, inputs, caller) -> CapturedScan:
        """Capture the head on static copies of `inputs`, the step on
        static buffers of the carry and of one x, and the tail on the
        step's static carry and the head's extras.  A scan whose step has a
        name takes the cache's step of that name and batch size where
        another scan captured it, and captures it for both otherwise.

        The head's graph copies its outputs into static buffers outside
        the pool: they must outlive W step replays, and a step captured
        before this head (this scan's own or a shared one) may run its
        temporaries through the pool blocks this head's capture is given;
        every other output in the pool is read before another graph
        replays.  So the step is captured first: its working set is the
        largest, and the head's and the tail's temporaries then fit in the
        blocks it leaves free.

        The Scan runs once before, eagerly on the cache's stream, with one
        step where the step is captured here (that builds the kernels and
        puts every constant on the device); those launches are counted,
        the captures' are not."""
        scan, cache, stream = self.fn, self.cache, self.cache.stream
        key = (scan.step_name, inputs[0].shape[0]) if scan.step_name else None
        step = cache.steps.get(key)
        static_inputs = self._static_inputs(inputs, caller)
        with torch.cuda.stream(stream):
            carry, xs, extras = scan.head(*static_inputs)
            k = len(carry)
            if step is None:
                scan.tail(scan.step(carry, xs[0]), *extras)
                statics = [torch.empty_like(c) for c in carry] + [torch.empty_like(xs[0])]
            else:
                scan.tail(carry, *extras)
                if not all(t.shape == c.shape and t.dtype == c.dtype
                           for t, c in zip(step.inputs, (*carry, xs[0]))):
                    raise ValueError(f"step {scan.step_name!r} was captured for another carry or x")
            head_outputs = [torch.empty_like(t) for t in (*carry, xs, *extras)]
        del carry, xs, extras

        def head_fn(*a):
            for static, t in zip(head_outputs, _flat_head(scan.head(*a))):
                static.copy_(t)
            return head_outputs

        if step is None:
            step = self._capture_graph(lambda *a: scan.step(tuple(a[:k]), a[k]), statics)
            if key:
                cache.steps[key] = step
        head = self._capture_graph(head_fn, static_inputs)
        tail = self._capture_graph(lambda *a: scan.tail(tuple(a[:k]), *a[k:]),
                                   step.inputs[:k] + list(head.outputs[k + 1:]))
        caller.wait_stream(stream)
        return CapturedScan(head, step, tail)


def _flat_head(out):
    """A Scan head's (carry, xs, extras) as one tuple of tensors."""
    carry, xs, extras = out
    return (*carry, xs, *extras)


class VerifyBatchGraphs(ProgramGraphs):
    """protocol.verify_blob_batch for one setup's `roots` and `tau2`, the
    program "verify_batch" of `cache` (a cache of its own if none is
    given).  A call takes the six staged batch inputs (blob, commitment
    and proof bytes, and the z, zw and w planes) and returns (verdict,
    packed masks)."""

    def __init__(self, roots: torch.Tensor, tau2, cache: GraphCache | None = None):
        if cache is None:
            cache = GraphCache(roots.device)
        super().__init__(cache, functools.partial(protocol.verify_blob_batch, roots=roots, tau2=tau2),
                         (roots, tau2))
        with cache.lock:
            cache.programs["verify_batch"] = self
