"""The q-th percentile, by nearest rank, of every request's latency in
the window in milliseconds: from the call's start to its return (the
loop is closed).  A call that raised counts as the slowest."""

import math


def read(ctx, q: float):
    if not ctx.calls:
        return None
    lat = sorted(math.inf if c.error else (c.end - c.start) * 1e3 for c in ctx.calls)
    value = lat[max(0, math.ceil(q / 100 * len(lat)) - 1)]
    return value if math.isfinite(value) else None
