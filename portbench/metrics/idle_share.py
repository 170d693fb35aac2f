"""100 x (1 - device busy / traced window): the union of the trace's device
intervals against the host clock's window of whole calls."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_ns / 1e9 / ctx.window_s)
