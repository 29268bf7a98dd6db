"""The port's device programs as captured CUDA graphs: its counterpart of the
JAX package's `@jax.jit` programs (kateth_tpu/kzg/protocol.py: batch verify
at :279 with pairing_check at :201, verify_kzg_bytes at :218, commit_comb at
:169, evaluate, quotient and the form conversions at :77, :127, :370 and
:375; kateth_tpu/curves/compress.py:41 and :68).

Each program of kzg/protocol.py that a Kzg runs on the card (batch verify,
single-point verify, the comb commit, the proof and the point validation)
is a fixed sequence of device operations for each batch size: no operation
in it reads a tensor back to the host, every constant it uses is already on
the device, and its kernels launch on the current stream.  So each is
captured once per (Kzg, program, batch size) and replayed for every call of
that size.  A replay is one host call that enqueues the whole program.

A `GraphCache` holds every graph of one Kzg: one lock, one stream and one
memory pool for all its programs.  A replay reads its graph's static input
buffers and writes the same output tensors each time, so each call's copies
in, replay and copies out run under the lock, on the cache's stream: that
stream waits for the caller's current stream before the copies in, and the
caller's stream waits for it after the copies out.  Threads may share a
Kzg, one committing while another verifies, and a caller may change its
current stream between calls.  All graphs share the pool: their replays
never overlap, and a replay's outputs are copied out before the next replay
of any program starts.

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
    `pool_reserved_bytes` newly reserved for the shared pool), and the
    number of replays so far."""

    graph: torch.cuda.CUDAGraph
    inputs: list
    outputs: tuple
    launches: dict
    pool_bytes: int
    pool_reserved_bytes: int
    replays: int = 0


class GraphCache:
    """The graphs of one Kzg on one CUDA device, by program name
    (`programs`) and, within a program, by batch size."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.programs: dict[str, ProgramGraphs] = {}
        self.lock = threading.Lock()
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()

    def program(self, name: str, fn, held=()) -> "ProgramGraphs":
        """The graphs of program `name`: fn(*inputs), a function of tensors
        that returns a tuple of tensors.  `held` are the setup tensors fn
        reads by address; the cache keeps them.  fn and held are taken at
        the first use of `name`."""
        with self.lock:
            graphs = self.programs.get(name)
            if graphs is None:
                graphs = self.programs[name] = ProgramGraphs(self, fn, held)
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
                captured.graph.replay()
                for out, o in zip(outputs, captured.outputs):
                    out.copy_(o, non_blocking=True)
            caller.wait_stream(cache.stream)
            captured.replays += 1
            cuda_lib.add_launch_counts(captured.launches)
        return tuple(outputs)

    def _capture(self, inputs, caller) -> CapturedBatch:
        """Capture for the shapes of `inputs`.  The inputs are copied into
        fresh static buffers and the program runs once on them eagerly on
        the cache's stream before the capture: that builds the kernels, puts
        every constant on the device and sets up cuBLAS for the stream.
        Those launches are counted; the capture's are not."""
        dev, stream = self.device, self.cache.stream
        static_inputs = [torch.empty_like(t) for t in inputs]
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            for static, t in zip(static_inputs, inputs):
                static.copy_(t, non_blocking=True)
            self.fn(*static_inputs)
        before = cuda_lib.launch_counts()
        # torch.cuda.graph empties the allocator's cache before it captures;
        # do it first, so that the reserved bytes after the capture differ
        # from these by what the capture added to the pool alone
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        allocated, reserved = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's host prefix (pinned buffers,
        # copies on its own stream) may run while this thread captures
        with torch.cuda.graph(graph, pool=self.cache.pool, stream=stream,
                              capture_error_mode="thread_local"):
            outputs = tuple(self.fn(*static_inputs))
        after = cuda_lib.launch_counts()
        launches = {k: {name: after[k][name] - before[k][name] for name in after[k]} for k in after}
        cuda_lib.add_launch_counts(launches, -1)  # recorded, not launched
        caller.wait_stream(stream)
        return CapturedBatch(graph, static_inputs, outputs, launches,
                             torch.cuda.memory_allocated(dev) - allocated,
                             torch.cuda.memory_reserved(dev) - reserved)


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
