"""Seconds from process start to the first timed call: imports, world,
weights, the program's build and the warm-up."""


def read(ctx):
    return ctx.setup_s
