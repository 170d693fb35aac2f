"""Device operations (kernels, copies, sets) in the trace per rollout step
run (eval) or per train step (train)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.steps:
        return None
    return len(ctx.trace.device) / ctx.steps
