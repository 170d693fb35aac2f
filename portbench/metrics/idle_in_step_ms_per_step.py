"""Device idle ms a rollout step in the gaps whose midpoint lies inside a
`rollout.step` span (portbench/spans.py, the spans profiler pass)."""

from portbench.spans import readings


def read(ctx):
    r = readings(ctx)
    return None if r is None else r.get("idle_in_step_ms_per_step")
