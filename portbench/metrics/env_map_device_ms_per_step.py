"""Device ms a rollout step of the operations launched inside the program's
`env.*` and `map.*` spans (portbench/spans.py, the spans profiler pass)."""

from portbench.spans import readings


def read(ctx):
    r = readings(ctx)
    return None if r is None else r.get("env_map_device_ms_per_step")
