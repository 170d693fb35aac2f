"""Where the device time of greedy HAMT eval goes, on the card.

    python -m vln_imagine_tpu_torch.eval.trace [--batch 64 8]

For each batch size: one `HamtTrainer.make_eval_step()` call at the released
R2R config (full width, bf16, seeded random weights) on bench.py's synthetic
world, traced with `torch.profiler` after a warm-up call.  Prints one JSON
line per batch: the host wall time of the traced call and of the same call
untraced (the faster of two, after a warm-up), the device busy time (the
union of the traced kernels' and copies' intervals), the idle share (busy
time against the untraced wall time: the profiler slows the host, not the
device), the attention kernel's share of device time, device
operations per step, and the kernels that take the most device time.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

from vln_imagine_tpu_torch.config import hamt_r2r_config
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world

ATTENTION_KERNEL = "attention_fwd_kernel"


def bench_world(cfg):
    """bench.py's synthetic world: 2 scans x 96 nodes, 36 views, 768-d."""
    world, _ = synthetic_world(num_scans=2, num_nodes=96,
                               max_candidates=cfg.env.max_candidates, views=36,
                               feat_dim=cfg.model.image_feat_size, seed=0)
    return world


def bench_episodes(world, cfg, batch: int):
    """bench.py's episodes (seed 1) at `batch`."""
    return synthetic_episodes(world, batch=batch,
                              max_gt_path_len=cfg.env.max_gt_path_len,
                              max_instr_len=cfg.env.max_instr_len,
                              max_imaginations=cfg.model.max_imagination_len,
                              vocab_size=cfg.model.vocab_size,
                              feat_dim=cfg.model.hidden_size, seed=1)


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def trace_eval(trainer, ep, top: int = 8) -> dict:
    """Profile one eval call on the card; `ep` already lies there."""
    from torch.profiler import ProfilerActivity, profile

    eval_step = trainer.make_eval_step()
    untraced_us = []
    for _ in range(3):  # the first call warms up
        t0 = time.perf_counter()
        eval_step(ep)
        torch.cuda.synchronize()
        untraced_us.append((time.perf_counter() - t0) * 1e6)
    untraced = min(untraced_us[1:])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, path_len = eval_step(ep)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = defaultdict(lambda: [0, 0.0])
    for e in device:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in device)
    steps = min(int(path_len.max()), trainer.cfg.env.max_action_len)
    attn_us = sum(t for n, (_, t) in by_name.items() if ATTENTION_KERNEL in n)
    kernel_sum = sum(t for _, t in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "batch": ep.batch, "steps": steps, "wall_ms": wall_us / 1e3,
        "untraced_wall_ms": untraced / 1e3, "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / untraced,
        "attention_ms": attn_us / 1e3,
        "attention_share_of_device": attn_us / kernel_sum,
        "device_ops": len(device), "device_ops_per_step": len(device) / steps,
        "top": [{"name": n[:90], "count": c, "ms": t / 1e3}
                for n, (c, t) in ranked],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[64, 8])
    args = ap.parse_args()
    from vln_imagine_tpu_torch.train.trainer import HamtTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = hamt_r2r_config()
    world = bench_world(cfg)
    trainer = HamtTrainer(cfg, world, device="cuda")
    for batch in args.batch:
        ep = bench_episodes(world, cfg, batch).to(trainer.device)
        print(json.dumps({"phase": "trace", "card": torch.cuda.get_device_name(0),
                          **trace_eval(trainer, ep)}), flush=True)


if __name__ == "__main__":
    main()
