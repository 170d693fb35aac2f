"""The object layer's readings in a traced run of a cell with objects: the
device time of the program's object spans, and how full the object slots
it sends through the pano encoder are.

The readers `portbench/metrics/{objects_device_ms_per_step,
object_slot_fill}.py` read `readings()`.  The first of them in a `--trace
1` run builds the cell again from the command line's `--workload` and
`--seed` (the measured cell's program is freed by then), runs the
traffic's warm-up calls, then one pass of its `trace_calls` calls with the
program's spans on, under `torch.profiler`:

- `objects_device_ms_per_step`: the device time of the operations launched
  inside an `env.objects`, `model.objects`, `model.ground` or
  `policy.ground` span (`spans.Attribution`, by correlation id), over the
  rollout steps run;
- `object_slot_fill`: 100 x the valid object tokens that the pass's
  served episodes need (the cell's census, `object_tokens`) over the
  program's `objects.slots` counter, the object tokens it encoded (B x Ko
  a step).

It prints one line, `portbench objects: {...}`: both readings' parts, the
device ms a step of each object span, and what the pass cost in seconds.
A program without spans or without the counter gives no readings, and
neither does a run that names no workload, finds no card, or a cell
without objects.
"""

from __future__ import annotations

import gc
import importlib
import json
import sys
import time
from pathlib import Path

from portbench.spans import Attribution, cell_args, from_profiler

ROOT = Path(__file__).resolve().parents[1]
SPANS = ("env.objects", "model.objects", "model.ground", "policy.ground")

_cache: dict = {}


def readings(ctx) -> dict | None:
    """The object readings of this run, computed once; None where the run
    is untraced or names no cell on the command line."""
    if "done" not in _cache:
        _cache["done"] = True
        _cache["value"] = None
        workload, seed = cell_args(sys.argv[1:])
        if (ctx.trace is not None and ctx.kind == "eval" and workload
                and seed is not None):
            _cache["value"] = measure(ROOT, workload, seed)
    return _cache["value"]


def is_object_span(names) -> bool:
    return any(n in SPANS for n in names)


def measure(root: Path, workload: str, seed: int, device: str = "cuda"):
    """Builds `workload` from `seed` again and runs the pass; the readings
    (the device ms only on the card), after printing the `portbench
    objects` line.  None where there is nothing to read."""
    import torch

    try:
        spans = importlib.import_module("vln_imagine_tpu_torch.utils.spans")
    except ImportError:
        return None
    from portbench.registry import Registry

    on_card = device == "cuda"
    if on_card and not torch.cuda.is_available():
        return None
    t0 = time.perf_counter()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    reg = Registry(root)
    wl = reg.workload(workload)
    config, traffic = reg.config(wl["config"]), reg.traffic(wl["traffic"])
    cell = getattr(reg.agent(config), traffic["cell"])(
        config, traffic, seed % 2 ** 63, torch.device(device))
    for i in range(traffic["warmup_calls"]):
        cell.call(i)
    sync()
    t_pass = time.perf_counter()
    n = traffic["trace_calls"]
    spans.take()
    before = spans.counts().get("objects.slots", 0)
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if on_card else [])
    with spans.on(), torch.profiler.profile(activities=acts) as prof:
        done = []
        for i in range(n):
            done.append((i, cell.call(i)))
            sync()
    slots = spans.counts().get("objects.slots", 0) - before
    records = [cell.record(i, out) for i, out in done]
    del done
    names = {r.name for r in spans.take()}
    t_read = time.perf_counter()
    att = Attribution(*from_profiler(prof, names)) if on_card else None
    del prof
    cell.free_program()
    tokens = cell.census(records)["object_tokens"] if slots else 0.0
    del cell, records
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    out = {"object_slot_fill": 100.0 * tokens / slots if slots else None}
    facts = {"calls": n, "object_tokens": tokens, "object_slots": slots}
    if att is not None:
        steps = sum(c for p, c in att.calls.items() if p.endswith("rollout.step"))
        if steps and slots:
            out["objects_device_ms_per_step"] = (
                att.device_under(is_object_span) / steps / 1e6)
        facts["steps"] = steps
        facts["device_ms_per_step"] = {
            s: att.device_under(lambda names, s=s: s in names) / max(steps, 1) / 1e6
            for s in SPANS}
    facts["measure_s"] = {"setup_and_warmup": t_pass - t0,
                          "pass": t_read - t_pass,
                          "total": time.perf_counter() - t0}
    print("portbench objects: " + json.dumps({**facts, **out}), flush=True)
    return out
