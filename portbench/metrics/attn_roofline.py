"""The attention kernels' share of their bytes roofline: the bytes the
census's attention calls need (each input read once, each output written
once) over the card's memory bandwidth, against the device time of the
kernels named in portbench/kernels/attention/, in %."""


def read(ctx):
    if ctx.trace is None or ctx.census is None or ctx.peaks is None:
        return None
    ns = ctx.trace.kernel_ns(ctx.kernel_patterns("attention"))
    if ns == 0:
        return None
    bound_s = ctx.census["attention_bytes"] / ctx.peaks["bytes_per_s"]
    return 100.0 * bound_s / (ns / 1e9)
