"""The share of the traced window, in percent, in which no operation ran
on the device: 100 (1 - busy / window)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.window_ns or not t.busy_ns:
        return None
    return 100 * (1 - t.busy_ns / t.window_ns)
