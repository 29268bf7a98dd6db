"""Device milliseconds an operation: the union of the device's activity
(kernels, copies, sets) in the traced window, over the operations."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.busy_ns or not ctx.trace_ops:
        return None
    return t.busy_ns / ctx.trace_ops / 1e6
