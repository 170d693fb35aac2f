"""Greedy-eval episodes completed per second: every episode of the counted
calls over the window from its start to the end of the last counted call."""


def read(ctx):
    return ctx.work / ctx.window_s if ctx.kind == "eval" else None
