"""Runs one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  A run builds the cell from its files
(`registry.py`), warms up on the cell's own shapes, times whole calls of
the program's entry for `--seconds` seconds (`window.py`), checks what the
counted calls produced against the plain float32 reference, and prints one
JSON object as the last line of standard output.  With `--trace 1` the
window is `trace_calls` calls under `torch.profiler` and the metrics are
the cell's per-layer ones; without, its end-to-end ones.  A traced run
first times the same calls untraced, and prints the tracer's share of the
traced window beside it.

Exit codes: 0 a result was printed (`correct` says whether the outputs
held); 3 no CUDA card, or fewer than the cell asks for; 4 JAX or the JAX
package was loaded.  Build and kernel caches live under `build/` of the
checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # before torch: set-up counts the imports

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vln_imagine_tpu")


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Ctx:
    """What a metric reader reads (see portbench/metrics/)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def log(tag: str, **facts) -> None:
    print(f"portbench {tag}: " + json.dumps(facts, default=str), flush=True)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START) -> dict:
    """One run of `workload`; returns the result object.  Any whole `seed`
    is taken modulo 2**63, so every one keys the generators."""
    import torch

    from portbench import smi
    from portbench.registry import Registry
    from portbench.window import run_window

    seed %= 2 ** 63
    reg = Registry(root)
    wl = reg.workload(workload)
    config = reg.config(wl["config"])
    traffic = reg.traffic(wl["traffic"])
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    kernels_before = _kernel_libs(root)

    cell_cls = getattr(reg.agent(config), traffic["cell"])
    t_cell = time.perf_counter()
    cell = cell_cls(config, traffic, seed, torch.device(device))
    t_warm = time.perf_counter()
    for i in range(traffic["warmup_calls"]):
        cell.call(i)
    sync()
    setup_s = time.perf_counter() - t_start
    card = smi.card() if on_card else {}  # after set-up: it takes a second
    log("setup", setup_s=setup_s, start_s=t_cell - t_start,
        **getattr(cell, "setup_parts", {}), warmup_s=time.perf_counter() - t_warm,
        kernels_built=_kernel_libs(root) != kernels_before,
        card=name, power_limit_w=card.get("power_limit_w"),
        max_sm_clock_mhz=card.get("max_sm_clock_mhz"))

    tr = None
    sampler = smi.Sampler().start() if on_card else None
    try:
        if trace:
            from torch.profiler import ProfilerActivity, profile

            from portbench.trace import Trace

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            # the same calls without the tracer first: their wall against
            # the traced window's is the tracer's share of it
            t0 = time.perf_counter()
            for i in range(traffic["trace_calls"]):
                cell.call(i)
                sync()
            untraced_s = time.perf_counter() - t0
            with profile(activities=acts) as prof:
                t0, done = time.perf_counter(), []
                for i in range(traffic["trace_calls"]):
                    done.append((i, cell.call(i)))
                    sync()
                window_s = time.perf_counter() - t0
            tr = Trace.from_profiler(prof)
        else:
            done, window_s = run_window(cell.call, seconds, sync)
    finally:
        clocks = sampler.stop() if sampler else {}
    steps = [cell.steps(out) for _, out in done]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    records = [cell.record(i, out) for i, out in done]
    log("window", calls=len(done), steps_per_call=steps,
        work_per_call=cell.per_call, window_s=window_s, clocks=clocks,
        **({"untraced_s": untraced_s, "tracer_share": 1 - untraced_s / window_s}
           if trace else {}))
    del done
    cell.free_program()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    readings, facts = cell.check(records, seed, traffic)
    failed = cell.failed(records)
    limits = reg.limits(workload)
    # the numbers with a limit are compared; the others are reported
    log("check", **facts, **{k: v for k, v in readings if k not in limits})
    compared = {k: {"value": v, "limit": limits[k]} for k, v in readings
                if k in limits}
    compared["invalid_outputs"] = {"value": failed, "limit": 0}
    correct = bool(limits) and all(c["value"] <= c["limit"]
                                   for c in compared.values())

    peaks = next((p for p in reg.peaks() if p["match"] in name), None)
    ctx = Ctx(kind=traffic["kind"], work=len(records) * cell.per_call,
              window_s=window_s, setup_s=setup_s, peak_bytes=peak,
              steps=sum(steps), census=cell.census(records) if trace else None,
              trace=tr, peaks=peaks, dtype=config["model"]["compute_dtype"],
              kernel_patterns=reg.kernel_patterns)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in reg.metrics(workload, section):
        value = reg.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name,
           "count": wl["chips"] if on_card else 0, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": ctx.work, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_ns / 1e9
        dev["window_s"] = window_s
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    result["compared"] = compared
    return result


def _kernel_libs(root: Path) -> set:
    return set((root / "build" / "kernels").glob("*.so"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    import torch

    from portbench.registry import Registry

    chips = Registry(ROOT).workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 4
    for k, c in result["compared"].items():
        print(f"portbench compared {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
