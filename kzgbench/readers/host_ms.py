"""Host milliseconds an operation: the benchmark's spans around each public
call in the traced window, less the blocking CUDA runtime calls inside
them (the profiler's host events named in `waits`), over the operations."""


def read(ctx, waits: list):
    t = ctx.trace
    if t is None or not t.span_ns or not ctx.trace_ops:
        return None
    return (t.span_ns - t.wait_ns(frozenset(waits))) / ctx.trace_ops / 1e6
