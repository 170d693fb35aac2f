"""Device ms a rollout step of the operations launched inside the program's
object spans, `env.objects`, `model.objects`, `model.ground` and
`policy.ground` (portbench/objects.py, its own profiled spans pass)."""

from portbench.objects import readings


def read(ctx):
    r = readings(ctx)
    return None if r is None else r.get("objects_device_ms_per_step")
