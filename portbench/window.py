"""The measured window: whole calls of the entry, back to back.

A call counts when it ends inside the window, closed by a device
synchronise.  The window's length is from its start to the end of the
last counted call, so a stall inside any counted call is in the rate, and
the call that runs past the end is neither counted nor timed.  The first
call always counts, so a window shorter than one call still measures one.
"""

from __future__ import annotations

import time


def run_window(call, seconds: float, sync=lambda: None, clock=time.perf_counter):
    """Calls `call(i)` for i = 0, 1, ... until `seconds` have passed.
    Returns ([(i, output)] of the counted calls, elapsed seconds from the
    start to the end of the last counted call)."""
    t0 = clock()
    done, end = [], t0
    i = 0
    while True:
        out = call(i)
        sync()
        t = clock()
        if done and t > t0 + seconds:
            break
        done.append((i, out))
        end = t
        i += 1
        if t >= t0 + seconds:
            break
    return done, end - t0
