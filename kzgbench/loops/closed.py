"""A closed loop of one caller: the next call starts when the last returns,
until `seconds` have passed; the window ends at the end of the last call
that started in it."""

from __future__ import annotations

import time


def drive(traffic, kzg, seconds: float, span):
    """Returns the window's calls and its seconds."""
    calls = []
    t0 = time.perf_counter()
    for call in traffic.calls():
        if time.perf_counter() - t0 >= seconds:
            break
        call.start = time.perf_counter()
        try:
            call.outputs = traffic.entry.run(kzg, call, span)
        except Exception as e:  # a failed call is counted and judged, not fatal
            call.error = f"{type(e).__name__}: {e}"
        call.end = time.perf_counter()
        calls.append(call)
    return calls, (calls[-1].end - t0 if calls else 0.0)
