"""Batch verification as one captured CUDA graph: the port's counterpart of
the JAX package's `@jax.jit` on verify_blob_batch_fused and pairing_check
(kateth_tpu/kzg/protocol.py:279 and :201).

`protocol.verify_blob_batch` is one fixed program for each padded batch
size: no operation in it reads a tensor back to the host, every constant it
uses is already on the device, and its kernels (K1-K5) launch on the current
stream.  So it is captured once per (setup, padded batch size) and replayed
for every batch of that size.  A replay is one host call that enqueues the
whole program, and the host goes on to the next batch's prefix while the
device works.

A replay reads the graph's static input buffers and writes the same output
tensors each time.  `VerifyBatchGraphs` therefore runs each call's copies
in, replay and copies out under a lock, on a stream of its own: that stream
waits for the caller's current stream before the copies in, and the
caller's stream waits for it after the copies out.  Threads may share a
setup's graphs, and a caller may change its current stream between calls.
All graphs of a setup share one memory pool: their replays never overlap,
and a replay's outputs are copied out before the next replay starts.

A failed capture or replay raises; there is no eager fallback on CUDA.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

from . import cuda_lib
from .kzg import protocol


@dataclass
class CapturedBatch:
    """One captured graph: its static inputs and outputs, the launches of
    one replay (a cuda_lib.launch_counts() difference), and the device
    memory its capture took from the caching allocator: `pool_bytes` left
    allocated (the outputs: the pool's other blocks are free between
    replays) and `pool_reserved_bytes` newly reserved for the shared pool."""

    graph: torch.cuda.CUDAGraph
    inputs: list
    outputs: tuple
    launches: dict
    pool_bytes: int
    pool_reserved_bytes: int


class VerifyBatchGraphs:
    """protocol.verify_blob_batch captured for one setup's `roots` and
    `tau2` on a CUDA device, one graph per padded batch size (`graphs`).
    The graphs read `roots` and `tau2` by address; this keeps references to
    them."""

    def __init__(self, roots: torch.Tensor, tau2):
        self.roots, self.tau2 = roots, tau2
        self.device = roots.device
        self.graphs: dict[int, CapturedBatch] = {}
        self._lock = threading.Lock()
        self._stream = torch.cuda.Stream(self.device)
        self._pool = torch.cuda.graph_pool_handle()

    def __call__(self, inputs):
        """Verify one staged batch (blob, commitment and proof bytes, and the
        z, zw and w planes, on the setup's device): the replay of its padded
        size's graph, captured at the first batch of that size.  Returns
        (verdict, packed masks), the caller's own tensors, not yet read
        back; nothing here waits for the device."""
        caller = torch.cuda.current_stream(self.device)
        with self._lock:
            nc = inputs[0].shape[0]
            captured = self.graphs.get(nc)
            if captured is None:
                captured = self.graphs[nc] = self._capture(inputs, caller)
            outputs = [torch.empty_like(o) for o in captured.outputs]  # on the caller's stream
            self._stream.wait_stream(caller)
            with torch.cuda.stream(self._stream):
                for static, t in zip(captured.inputs, inputs):
                    static.copy_(t, non_blocking=True)
                captured.graph.replay()
                for out, o in zip(outputs, captured.outputs):
                    out.copy_(o, non_blocking=True)
            caller.wait_stream(self._stream)
            cuda_lib.add_launch_counts(captured.launches)
        return tuple(outputs)

    def _capture(self, inputs, caller) -> CapturedBatch:
        """Capture for the shapes of `inputs`.  The inputs are copied into
        fresh static buffers and the program runs once on them eagerly on
        the graphs' stream before the capture: that builds the kernels, puts
        every constant on the device and sets up cuBLAS for the stream.
        Those launches are counted; the capture's are not."""
        dev = self.device
        static_inputs = [torch.empty_like(t) for t in inputs]
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            for static, t in zip(static_inputs, inputs):
                static.copy_(t, non_blocking=True)
            protocol.verify_blob_batch(*static_inputs, self.roots, self.tau2)
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
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            outputs = protocol.verify_blob_batch(*static_inputs, self.roots, self.tau2)
        after = cuda_lib.launch_counts()
        launches = {k: {name: after[k][name] - before[k][name] for name in after[k]} for k in after}
        cuda_lib.add_launch_counts(launches, -1)  # recorded, not launched
        caller.wait_stream(self._stream)
        return CapturedBatch(graph, static_inputs, outputs, launches,
                             torch.cuda.memory_allocated(dev) - allocated,
                             torch.cuda.memory_reserved(dev) - reserved)
