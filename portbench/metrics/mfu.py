"""The whole step's share of the card's dense peak: the model FLOPs the
inputs need (the benchmark's census, from the configuration's widths and
the episodes' own lengths and steps) over the traced window, in %."""


def read(ctx):
    if ctx.trace is None or ctx.census is None or ctx.peaks is None:
        return None
    peak = ctx.peaks["flops"].get(ctx.dtype)
    if not peak:
        return None
    return 100.0 * ctx.census["flops"] / ctx.window_s / peak
