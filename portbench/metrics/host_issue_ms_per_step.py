"""Mean host ms from a `rollout.step` span's start to its
`rollout.host_read`: the host's time to issue one step (portbench/spans.py,
the spans pass, no profiler)."""

from portbench.spans import readings


def read(ctx):
    r = readings(ctx)
    return None if r is None else r.get("host_issue_ms_per_step")
