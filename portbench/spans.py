"""The program's own spans and counters, read by a traced run: which phase of
a call launched each device operation, where the device waited, and the
host's time to issue one rollout step.

The four readers `portbench/metrics/{env_map_device_ms_per_step,
idle_in_step_ms_per_step, host_issue_ms_per_step, host_syncs_per_step}.py`
read `readings()`.  The first of them in a `--trace 1` run builds the cell
again from the command line's `--workload` and `--seed` (the measured
cell's program is freed once its calls are checked), with the program's
spans on, so that its set-up parts are spans too.  After the traffic's
warm-up calls it runs passes of the traffic's `trace_calls` calls:

1. half a pass with spans off, a pass with spans on, the other half with
   spans off, with no profiler (a drift of the host's pace falls on both
   sides).  The spans pass gives the host-clock records and the
   program's counters: `host_issue_ms_per_step` is the mean time from a
   `rollout.step`'s start to the start of its `rollout.host_read`, the
   host's time to issue the step, a wait on a full launch queue included;
   `host_syncs_per_step` is `host_reads` over `rollout.steps`;
   `spans_share` is 1 - (the wall with spans off) / (the wall with spans
   on), what the spans cost when on;
2. spans on, under `torch.profiler`: each span is a `record_function`
   annotation on the profiler's timeline.  Each device operation is
   attributed by its correlation id to the CUDA runtime or driver call that
   launched it, and so to the innermost span open at that moment; each idle
   gap between busy stretches, to the innermost span open at its midpoint
   (`Attribution`).  `env_map_device_ms_per_step` is the device time of the
   operations launched inside an `env.*` or `map.*` span,
   `idle_in_step_ms_per_step` the idle time of the gaps inside a
   `rollout.step`, each over the steps run.

It then prints one line, `portbench spans: {...}`: for every span path, per
eval call, `[spans, host ms, device ms, idle ms]`, each the path's own, less
its children's (host ms from the spans pass, device and idle ms from the
profiled pass); the program's set-up parts; and the checks: the share of
device time under some span, `rollout.step`'s own share of in-step device
time, and the idle time in and out of steps against the pass's.  A program
without spans (`vln_imagine_tpu_torch/utils/spans.py`) gives no readings,
and neither does a run that names no workload or finds no card.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from bisect import bisect_right
from collections import defaultdict
from pathlib import Path

from portbench.trace import merged

ROOT = Path(__file__).resolve().parents[1]
# the host-side calls that launch device work are the CUDA runtime's and
# driver's (cudaLaunchKernel, cudaLaunchKernelExC, cuLaunchKernelEx,
# cudaMemcpyAsync, ...): a device event carries the correlation id of its
# launch
LAUNCH_PREFIX = "cu"

_cache: dict = {}


class Attribution:
    """Device time and idle gaps by the span path that caused them.

    annotations: [(start, end, name)] of properly nested spans; launches:
    {correlation id: launch time}; device: [(start, end, correlation id)].
    A path is the span names from the root down, joined by '/'; None
    stands for no span."""

    def __init__(self, annotations, launches, device):
        ann = sorted(annotations, key=lambda a: (a[0], -a[1]))
        self.starts = [a[0] for a in ann]
        self.ends = [a[1] for a in ann]
        self.parent, self.paths, stack = [], [], []
        for i, (s, _, name) in enumerate(ann):
            while stack and self.ends[stack[-1]] <= s:
                stack.pop()
            p = stack[-1] if stack else None
            self.parent.append(p)
            self.paths.append(name if p is None else self.paths[p] + "/" + name)
            stack.append(i)
        self.calls = defaultdict(int)
        for path in self.paths:
            self.calls[path] += 1

        self.device_ns = defaultdict(int)
        self.unlaunched_ns = 0  # operations whose launch is not in the trace
        for s, e, corr in device:
            t = launches.get(corr)
            if t is None:
                self.unlaunched_ns += e - s
            else:
                self.device_ns[self.path_at(t)] += e - s
        busy = merged((s, e) for s, e, _ in device)
        self.busy_ns = sum(e - s for s, e in busy)
        # the window: the first span's start to the last span's or
        # operation's end
        self.window = (min(self.starts + [b[0] for b in busy[:1]], default=0),
                       max(self.ends + [b[1] for b in busy[-1:]], default=0))
        self.idle_ns = defaultdict(int)
        edge = self.window[0]
        for s, e in busy + [[self.window[1], self.window[1]]]:
            if s > edge:
                self.idle_ns[self.path_at((edge + s) / 2)] += s - edge
            edge = max(edge, e)

    def path_at(self, t):
        """The path of the innermost span open at time t, or None."""
        i = bisect_right(self.starts, t) - 1
        while i is not None and i >= 0 and self.ends[i] <= t:
            i = self.parent[i]
        return None if i is None or i < 0 else self.paths[i]

    def device_under(self, test) -> int:
        return sum(ns for path, ns in self.device_ns.items()
                   if path is not None and test(path.split("/")))

    def idle_under(self, test) -> int:
        return sum(ns for path, ns in self.idle_ns.items()
                   if path is not None and test(path.split("/")))


def is_env_or_map(names) -> bool:
    return any(n.startswith(("env.", "map.")) for n in names)


def in_step(names) -> bool:
    return "rollout.step" in names


def from_profiler(prof, names: set):
    """(annotations, launches, device) of a profiler's events: the CPU
    events named as spans, the launches by correlation id, and the device
    operations (the profiler's device-side copies of the annotations left
    out)."""
    from torch.autograd import DeviceType

    annotations, launches, device = [], {}, []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if name not in names:
                s = ev.start_ns()
                device.append((s, s + ev.duration_ns(), ev.correlation_id()))
        elif name in names:
            s = ev.start_ns()
            annotations.append((s, s + ev.duration_ns(), name))
        elif name.startswith(LAUNCH_PREFIX):
            launches[ev.correlation_id()] = ev.start_ns()
    return annotations, launches, device


def host_table(records, self_ns) -> tuple[dict, dict]:
    """Calls and host ns of every span path of `records`: the paths' own
    time (`self_ns` of each record's id), so that they sum to the roots'."""
    by_id = {r.id: r for r in records}
    paths, calls, host = {}, defaultdict(int), defaultdict(int)
    for r in records:  # by start: a parent before its children
        p = by_id.get(r.parent)
        paths[r.id] = r.name if p is None else paths[p.id] + "/" + r.name
        calls[paths[r.id]] += 1
        host[paths[r.id]] += self_ns[r.id]
    return calls, host


def issue_ns(records) -> list[int]:
    """Per rollout step, the host time from its start to its host read."""
    steps = {r.id: r for r in records if r.name == "rollout.step"}
    return [r.start_ns - steps[r.parent].start_ns for r in records
            if r.name == "rollout.host_read" and r.parent in steps]


def cell_args(argv) -> tuple[str | None, int | None]:
    """The `--workload` and `--seed` of a command line, in either of the
    forms `portbench.run` takes (`--seed 7`, `--seed=7`)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    args, _ = ap.parse_known_args(argv)
    return args.workload, args.seed


def readings(ctx) -> dict | None:
    """The spans metrics of this run, computed once; None where the run is
    untraced, names no cell on the command line, finds no card, or the
    program has no spans."""
    if "done" not in _cache:
        _cache["done"] = True
        _cache["value"] = None
        workload, seed = cell_args(sys.argv[1:])
        if (ctx.trace is not None and ctx.kind == "eval" and workload
                and seed is not None):
            _cache["value"] = measure(ROOT, workload, seed)
    return _cache["value"]


def measure(root: Path, workload: str, seed: int, device: str = "cuda"):
    """Builds `workload` from `seed` again and runs the passes; the
    readings, after printing the `portbench spans` line.  None where the
    program has no spans or (on the card) torch finds none."""
    import torch

    try:
        spans = importlib.import_module("vln_imagine_tpu_torch.utils.spans")
    except ImportError:
        return None
    from portbench.registry import Registry

    on_card = device == "cuda"
    if on_card and not torch.cuda.is_available():
        return None
    t_measure = time.perf_counter()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    reg = Registry(root)
    wl = reg.workload(workload)
    config, traffic = reg.config(wl["config"]), reg.traffic(wl["traffic"])
    cell_cls = getattr(reg.agent(config), traffic["cell"])
    spans.take()
    with spans.on():
        cell = cell_cls(config, traffic, seed % 2 ** 63, torch.device(device))
    setup = defaultdict(float)
    for r in spans.take():
        if r.parent is None and r.name.startswith("setup."):
            setup[r.name] += (r.end_ns - r.start_ns) / 1e6
    for i in range(traffic["warmup_calls"]):
        cell.call(i)
    sync()
    n = traffic["trace_calls"]
    t_passes = time.perf_counter()

    def calls(count):
        t0 = time.perf_counter()
        for i in range(count):
            cell.call(i)
            sync()
        return time.perf_counter() - t0

    # n calls each way, spans off around spans on: a drift of the host's
    # pace falls on both sides
    untraced_s = calls(n - n // 2)
    before = spans.counts()
    with spans.on():
        spans_s = calls(n)
    records = spans.take()
    after = spans.counts()
    untraced_s += calls(n // 2)
    steps = after.get("rollout.steps", 0) - before.get("rollout.steps", 0)
    reads = after.get("host_reads", 0) - before.get("host_reads", 0)
    names = {r.name for r in records}
    timing = {"setup_s": t_passes - t_measure,
              "passes_s": time.perf_counter() - t_passes}
    att = None
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        t_profile = time.perf_counter()
        with spans.on(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
            profiled_s = calls(n)
        spans.take()
        att = Attribution(*from_profiler(prof, names))
        del prof
        timing["profile_s"] = time.perf_counter() - t_profile
    cell.free_program()
    del cell
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    calls_by_path, host = host_table(records, spans.self_ns(records))
    issue = issue_ns(records)
    out = {"host_issue_ms_per_step": sum(issue) / len(issue) / 1e6 if issue
           else None,
           "host_syncs_per_step": reads / steps if steps else None}
    facts = {"calls": n, "steps": steps, "host_reads": reads,
             "untraced_s": untraced_s, "spans_s": spans_s,
             "spans_share": 1 - untraced_s / spans_s, "setup_ms": dict(setup)}
    # per eval call: spans, host ms (the spans pass), device and idle ms (the
    # profiled pass)
    table = {p: [calls_by_path[p] / n, host[p] / 1e6 / n, None, None]
             for p in host}
    if att is not None:
        psteps = sum(c for p, c in att.calls.items()
                     if p.endswith("rollout.step"))
        device_ns = sum(att.device_ns.values()) + att.unlaunched_ns
        step_ns = att.device_under(in_step)
        step_self = sum(ns for p, ns in att.device_ns.items()
                        if p is not None and p.endswith("rollout.step"))
        idle_in = att.idle_under(in_step)
        idle_all = sum(att.idle_ns.values())
        if psteps:
            out["env_map_device_ms_per_step"] = (
                att.device_under(is_env_or_map) / psteps / 1e6)
            out["idle_in_step_ms_per_step"] = idle_in / psteps / 1e6
        for p in set(att.device_ns) | set(att.idle_ns):
            row = table.setdefault(p or "(no span)",
                                   [att.calls.get(p, 0) / n, None, None, None])
            row[2:] = [att.device_ns.get(p, 0) / 1e6 / n,
                       att.idle_ns.get(p, 0) / 1e6 / n]
        facts.update(
            profiled_s=profiled_s, profiled_steps=psteps,
            busy_ms=att.busy_ns / 1e6, unlaunched_ms=att.unlaunched_ns / 1e6,
            under_spans_share=(device_ns - att.device_ns.get(None, 0)
                               - att.unlaunched_ns) / device_ns
            if device_ns else None,
            step_self_share=step_self / step_ns if step_ns else None,
            idle_in_steps_ms=idle_in / 1e6,
            idle_out_of_steps_ms=(idle_all - idle_in) / 1e6,
            idle_window_ms=(att.window[1] - att.window[0] - att.busy_ns) / 1e6,
            idle_wall_ms=profiled_s * 1e3 - att.busy_ns / 1e6)
    facts["measure_s"] = dict(timing, total=time.perf_counter() - t_measure)
    print("portbench spans: " + json.dumps(
        {**facts, "per_call": ["spans", "host_ms", "device_ms", "idle_ms"],
         "paths": dict(sorted(table.items()))}), flush=True)
    return out
