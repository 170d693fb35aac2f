"""Readings that the limits of `correct` are set from, on the card.

    python3 -m portbench.calibrate --workload <name> --seeds 1 2 3 ... [--control]

For each seed, in one process: the cell's set-up, a short window of
whole calls (one pass over the split, every batch once), and
the check's numbers; with `--control` also the control's, the float32
reference with its linear layers in fp8 e4m3 (per-tensor scale) put in
the program's place: the widest gap of the actions it ranks first.  One
JSON line a seed.  The limit of each number lies between the largest
reading of the program and the smallest of the control (PERF.md).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

from portbench.run import ROOT, cache_dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    import torch

    from portbench.registry import Registry

    reg = Registry(ROOT)
    wl = reg.workload(args.workload)
    config, traffic = reg.config(wl["config"]), reg.traffic(wl["traffic"])
    cell_cls = getattr(reg.agent(config), traffic["cell"])
    modes = ("float32", "fp8") if args.control else ("float32",)
    for seed in args.seeds:
        cell = cell_cls(config, traffic, seed, torch.device("cuda"))
        outs = [(i, cell.call(i)) for i in range(traffic["split"] // cell.per_call)]
        torch.cuda.synchronize()
        steps = [cell.steps(o) for _, o in outs]
        records = [cell.record(i, o) for i, o in outs]
        del outs
        cell.free_program()
        gc.collect()
        torch.cuda.empty_cache()
        readings, facts = cell.check(records, seed, traffic, modes)
        print(json.dumps({"seed": seed, "steps_per_call": steps,
                          **dict(readings), **facts,
                          "invalid_outputs": cell.failed(records)}), flush=True)
        del cell, records
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
