"""The program's `host_reads` counter over its `rollout.steps` counter
(portbench/spans.py, the spans pass)."""

from portbench.spans import readings


def read(ctx):
    r = readings(ctx)
    return None if r is None else r.get("host_syncs_per_step")
