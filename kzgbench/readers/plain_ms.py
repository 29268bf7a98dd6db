"""Device milliseconds an operation in kernels that are none of the port's
hand-written ones (kzgbench/port_kernels.json): the plain field and curve
operations, PyTorch's own kernels."""

import json
import os

KERNELS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "port_kernels.json")


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.trace_ops:
        return None
    with open(KERNELS) as f:
        port = json.load(f)["kernels"]
    ns = sum(v[1] for name, v in t.by_name.items()
             if not name.startswith("Memcpy") and not name.startswith("Memset")
             and not any(k in name for k in port))
    return ns / ctx.trace_ops / 1e6 if ns else None
