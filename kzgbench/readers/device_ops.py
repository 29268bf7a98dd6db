"""Device operations (kernels, copies, sets) in the traced window, over
the operations: a count that repeats exactly while the program does."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device_ops or not ctx.trace_ops:
        return None
    return t.device_ops / ctx.trace_ops
