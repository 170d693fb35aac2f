"""Where the device time of greedy eval and of the train step goes, on the
card, for either agent.

    python -m vln_imagine_tpu_torch.eval.trace [--agent hamt|duet] [--batch 64 8]
    python -m vln_imagine_tpu_torch.eval.trace --train [--agent ...] [--batch 8]

Eval: for each batch size, one `make_eval_step()` call of `HamtTrainer` or
`DuetTrainer` at the agent's released R2R config (full width, bf16, seeded
random weights) on bench.py's synthetic world.  Train (`--train`): one
step of the released recipe on the same world and episodes: HAMT's
`make_train_step("sample")` (IL + RL), DUET's `make_train_step()` (IL +
DAgger), attention dropout on.  Each call is traced with `torch.profiler`
after warm-up calls.  Prints one JSON line
per batch: the host wall time of the traced call and of the same call
untraced (the faster of two, after a warm-up), the device busy time (the
union of the traced kernels' and copies' intervals), the idle share (busy
time against the untraced wall time: the profiler slows the host, not the
device), the attention kernels' shares of device time, device operations
(per step for eval), and the kernels that take the most device time.  The
forward kernel of `csrc/attention_fwd.cu` runs as K1 in eval and as K2 in
training (one CUDA function, dropout chosen at run time).  A backward call
(K3 in training, K4 with dropout off) is two CUDA functions of
`csrc/attention_bwd.cu`, the dQ kernel then the dK/dV kernel; the trace
reports their sum as "K3 / K4", with the launches of each function.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

from vln_imagine_tpu_torch.config import duet_r2r_config, hamt_r2r_config
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world

# CUDA function name -> (the kernels it runs as, its source under csrc/)
ATTENTION_KERNELS = {
    "attention_fwd_kernel": ("K1 / K2", "attention_fwd.cu"),
    "attention_bwd_dq_kernel": ("K3 / K4", "attention_bwd.cu"),
    "attention_bwd_dkdv_kernel": ("K3 / K4", "attention_bwd.cu"),
}


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


def _trace_call(fn, top: int = 8) -> dict:
    """Profile one call of `fn` on the card after warm-up calls."""
    from torch.profiler import ProfilerActivity, profile

    untraced_us = []
    for _ in range(3):  # the first call warms up
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        untraced_us.append((time.perf_counter() - t0) * 1e6)
    untraced = min(untraced_us[1:])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
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
    kernel_sum = sum(t for _, t in by_name.values())
    attention = {}
    for fn_name, (runs_as, _) in ATTENTION_KERNELS.items():
        count = sum(c for n, (c, _) in by_name.items() if fn_name in n)
        us = sum(t for n, (_, t) in by_name.items() if fn_name in n)
        entry = attention.setdefault(runs_as, {"launches": {}, "ms": 0.0})
        entry["launches"][fn_name] = count
        entry["ms"] += us / 1e3
    for entry in attention.values():
        entry["share_of_device"] = entry["ms"] * 1e3 / kernel_sum
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return out, {
        "wall_ms": wall_us / 1e3, "untraced_wall_ms": untraced / 1e3,
        "device_busy_ms": busy / 1e3, "idle_share": 1.0 - busy / untraced,
        "attention": attention, "device_ops": len(device),
        "top": [{"name": n[:90], "count": c, "ms": t / 1e3}
                for n, (c, t) in ranked],
    }


def eval_steps(trainer, ep, path_len) -> int:
    """Steps the greedy eval loop ran.  HAMT records one node a step, so its
    paths say it: the loop breaks after the step at which the last item
    stopped, and an item that stops at step s has path_len s + 1.  A DUET
    step may record several nodes (teleports, the stop-node backtrack), so
    the rollout is run once more for its step count."""
    if trainer.cfg.agent == "hamt":
        return min(int(path_len.max()), trainer.cfg.env.max_action_len)
    from vln_imagine_tpu_torch.train.rollout_duet import rollout_duet

    return rollout_duet(trainer.model, trainer.tables, ep, trainer.cfg,
                        early_exit=True).steps


def trace_eval(trainer, ep, top: int = 8) -> dict:
    """Profile one eval call on the card; `ep` already lies there."""
    eval_step = trainer.make_eval_step()
    (_, path_len), out = _trace_call(lambda: eval_step(ep), top)
    steps = eval_steps(trainer, ep, path_len)
    return {"batch": ep.batch, "steps": steps, **out,
            "device_ops_per_step": out["device_ops"] / steps}


def trace_train(trainer, ep, top: int = 8) -> dict:
    """Profile one train step of the released recipe on the card (both of
    its rollouts on `ep`); `ep` already lies there."""
    train_step = (trainer.make_train_step("sample")
                  if trainer.cfg.agent == "hamt" else trainer.make_train_step())
    metrics, out = _trace_call(lambda: train_step(ep, ep), top)
    return {"batch": ep.batch, "loss": float(metrics["loss"]), **out}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agent", choices=("hamt", "duet"), default="hamt")
    ap.add_argument("--batch", type=int, nargs="+", default=None,
                    help="batch sizes (eval: 64 8; train: 8)")
    ap.add_argument("--train", action="store_true",
                    help="trace the train step instead of eval")
    args = ap.parse_args()
    from vln_imagine_tpu_torch.train.trainer import HamtTrainer
    from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = hamt_r2r_config() if args.agent == "hamt" else duet_r2r_config()
    world = bench_world(cfg)
    trainer = (HamtTrainer if args.agent == "hamt" else DuetTrainer)(
        cfg, world, device="cuda")
    batches = args.batch or ([cfg.train.batch_size] if args.train else [64, 8])
    for batch in batches:
        ep = bench_episodes(world, cfg, batch).to(trainer.device)
        out = trace_train(trainer, ep) if args.train else trace_eval(trainer, ep)
        print(json.dumps({"phase": "trace_train" if args.train else "trace",
                          "agent": args.agent,
                          "card": torch.cuda.get_device_name(0), **out}),
              flush=True)


if __name__ == "__main__":
    main()
