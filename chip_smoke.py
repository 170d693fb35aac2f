#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`vln_imagine_tpu_torch`).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, each printing one
JSON line; any failed check exits non-zero:

1. build      compile `vln_imagine_tpu_torch/csrc/attention_fwd.cu` with nvcc
              for sm_90a into `build/kernels/` and load it.
2. main_path  HAMT-Imagine greedy eval (`HamtTrainer.make_eval_step`) at the
              released R2R config, full width, bf16, on the synthetic world of
              bench.py (2 scans x 96 nodes x 36 views x 768 features), batch 64
              and 8, seeded random weights: valid walks, the attention launch
              count (9 + 18 per step), episodes/s, SR/SPL/nDTW, peak memory.
3. parity     the same weights in f32 at batch 4: the port on the card (kernel)
              against the port on the CPU (plain version): identical paths,
              step-0 logits within LOGIT_TOL.
4. kernels    the attention kernel against its plain PyTorch version on the
              card, at every (Lq, Lk) of the HAMT eval path, B 8 and 64, bf16
              and f32, [B,1,1,Lk] mask and per-head bias, q/k/v as views of a
              packed projection; kernel, plain and library times (CUDA-graph
              replays between CUDA events) beside the least time the card
              could take.

Then the kernel summary line `{"kernels": [...]}`, the card's name and power
limit, and last the result line.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "vln_imagine_tpu_torch/csrc/attention_fwd.cu"
REPLACES = "vln_imagine_tpu/ops/attention.py:57"  # _fwd_kernel

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# rate of the kernel's arithmetic for its input type (bf16 on tensor cores,
# f32 outside them: TF32 stays off)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel vs plain, both on the card.  f32: the same products summed in
# another order (64-term dot products, <= 80-term PV sums) differ by ~1e-6;
# 1e-4 leaves room.  bf16: P and O are rounded to bf16 on both sides, so a
# score one f32 ulp apart can flip P by one bf16 ulp and O by one (2^-7 at
# |O| ~ 1); atol and rtol 1e-2 cover about two ulps.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# step-0 action logits, f32, card vs CPU: 13 transformer layers of width 768
# on two math libraries (cuBLAS vs the CPU's BLAS)
LOGIT_TOL = 1e-3

# (Lq, Lk) of every attention call of HAMT greedy eval at the released
# config: language self 60/60; x-layer cross 80/67 and 67/80, self 80/80
# and 67/67 (80 = 60 text + 20 imagination, 67 = 16 history + 51 obs);
# history pano encoder 36/36
SHAPES = [(60, 60), (80, 80), (80, 67), (67, 80), (67, 67), (36, 36)]
HEADS, HEAD_DIM = 12, 64
BATCHES = (64, 8)
REPRESENTATIVE = (64, 67, 67, "bfloat16", "mask")  # the summary line's case


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        print(f"chip_smoke: FAILED: {what}", file=sys.stderr, flush=True)
        raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, repeats: int = 5) -> float:
    """Device time of one call: `iters` calls captured in a CUDA graph,
    replayed `repeats` times between CUDA events, median over the replays
    divided by `iters`.  The graph keeps the host's launch rate out of the
    number (at B 8 a call takes the device less time than Python takes to
    launch it).  Inputs stay warm in L2, as on the main path, where the
    projection that produced q/k/v ran just before."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


# --------------------------------------------------------------- phase 2
def check_walks(world, ep, nodes, lens, T):
    """Every path starts at its start node, stays within T+1 entries, and
    each move follows a valid edge of `adj`."""
    import numpy as np

    adj, adj_valid = np.asarray(world.adj), np.asarray(world.adj_valid)
    scan, start = np.asarray(ep.scan), np.asarray(ep.start_node)
    for b in range(len(lens)):
        n = int(lens[b])
        check(1 <= n <= T + 1, f"item {b}: path length {n}")
        path = nodes[b, :n]
        check(path[0] == start[b], f"item {b}: path does not start at start")
        for a, c in zip(path[:-1], path[1:]):
            nbrs = adj[scan[b], a][adj_valid[scan[b], a]]
            check(c in nbrs, f"item {b}: {a} -> {c} is not an edge")


def main_path_phase(torch, cfg, world):
    import numpy as np

    from vln_imagine_tpu_torch.eval.metrics import (
        eval_batch,
        trajectories_from_rollout,
    )
    from vln_imagine_tpu_torch.eval.trace import bench_episodes
    from vln_imagine_tpu_torch.ops.attention import fused_attention
    from vln_imagine_tpu_torch.train.trainer import HamtTrainer

    T = cfg.env.max_action_len
    # attention calls: one per language layer once per episode; per step,
    # four per cross-modal layer and one per history pano layer (9 + 18 at
    # the released config)
    m = cfg.model
    per_episode, per_step = m.num_l_layers, 4 * m.num_x_layers + m.num_pano_layers
    t0 = time.perf_counter()
    trainer = HamtTrainer(cfg, world, device="cuda")
    eval_step = trainer.make_eval_step()
    eps_np = {B: bench_episodes(world, cfg, B) for B in BATCHES}
    eps = {B: eps_np[B].to("cuda") for B in BATCHES}
    for B in BATCHES:  # warm-up: cuBLAS handles, the bf16 weight copies
        eval_step(eps[B])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # the counted run: every count set to 0 just before, read just after
    fused_attention.launches = 0
    runs = {}
    for B in BATCHES:
        before = fused_attention.launches
        nodes, lens = eval_step(eps[B])
        nodes, lens = nodes.cpu().numpy(), lens.cpu().numpy()
        runs[B] = (nodes, lens, fused_attention.launches - before)
    launches = fused_attention.launches

    results = []
    for B in BATCHES:
        nodes, lens, count = runs[B]
        ep, ep_np = eps[B], eps_np[B]
        check_walks(world, ep_np, nodes, lens, T)
        # the loop breaks after the step at which the last item stopped:
        # an item that stops at step s has path_len s + 1
        steps = min(int(lens.max()), T)
        want = per_episode + per_step * steps
        check(count == want, f"batch {B}: {count} attention launches for "
              f"{steps} steps, expected {want}")

        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t = time.perf_counter()
            out = eval_step(ep)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            check(np.array_equal(out[0].cpu().numpy(), nodes),
                  f"batch {B}: greedy paths differ between runs")
        dt = statistics.median(times)
        gt = [list(p[:n]) for p, n in zip(ep_np.gt_path, ep_np.gt_len)]
        summary, _ = eval_batch(np.asarray(world.dist), ep_np.scan,
                                trajectories_from_rollout(nodes, lens), gt)
        results.append({
            "batch": B, "steps": steps, "attention_launches": count,
            "episodes_per_s": B / dt, "episode_batch_ms": dt * 1e3,
            "episode_batch_ms_all": [x * 1e3 for x in times],
            "sr": summary["sr"], "spl": summary["spl"],
            "nDTW": summary["nDTW"],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        })
    emit({"phase": "main_path", "config": "hamt_r2r_config",
          "compute_dtype": cfg.model.compute_dtype,
          "params": sum(p.numel() for p in trainer.model.parameters()),
          "setup_s": setup_s, "runs": results})
    del trainer
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- phase 3
def parity_phase(torch, cfg, world):
    import numpy as np

    from vln_imagine_tpu_torch.config import _replace
    from vln_imagine_tpu_torch.eval.trace import bench_episodes
    from vln_imagine_tpu_torch.ops.attention import fused_attention
    from vln_imagine_tpu_torch.train.rollout_hamt import rollout_hamt
    from vln_imagine_tpu_torch.train.trainer import HamtTrainer

    cfg32 = _replace(cfg, "model", compute_dtype="float32")
    ep = bench_episodes(world, cfg32, 4)
    out = {}
    for dev in ("cuda", "cpu"):
        trainer = HamtTrainer(cfg32, world, device=dev)
        before = fused_attention.launches
        nodes, lens = trainer.make_eval_step()(ep)
        step0 = rollout_hamt(trainer.model, trainer.tables, ep.to(dev), cfg32,
                             max_steps=1, early_exit=False).logits[0]
        launched = fused_attention.launches - before
        check(launched > 0 if dev == "cuda" else launched == 0,
              f"{dev}: {launched} kernel launches")
        out[dev] = (nodes.cpu().numpy(), lens.cpu().numpy(),
                    step0.float().cpu().numpy())
        del trainer
    (gn, gl, glog), (cn, cl, clog) = out["cuda"], out["cpu"]
    valid = clog > -1e8
    check(np.array_equal(valid, glog > -1e8), "masked logit slots differ")
    err = float(np.abs(glog[valid] - clog[valid]).max())
    emit({"phase": "parity", "compute_dtype": "float32", "batch": 4,
          "paths_identical": bool(np.array_equal(gn, cn)
                                  and np.array_equal(gl, cl)),
          "path_len": gl.tolist(), "step0_logit_max_abs_err": err,
          "tol": LOGIT_TOL})
    check(np.array_equal(gn, cn) and np.array_equal(gl, cl),
          "greedy paths differ between the card and the CPU")
    check(err <= LOGIT_TOL, f"step-0 logits differ by {err}")


# --------------------------------------------------------------- phase 4
def kernel_case(torch, B, lq, lk, dtype_name, bias_kind, gen):
    import torch.nn.functional as F

    from vln_imagine_tpu_torch.ops.attention import (
        attention_reference,
        fused_attention,
    )
    from vln_imagine_tpu_torch.ops.masks import extend_neg_mask

    dev, dtype = "cuda", getattr(torch, dtype_name)
    H, D = HEADS, HEAD_DIM
    # q from one packed [B, Lq, 3*H*D] product, k/v from another: strided
    # views with row stride 2304, as MHAttention hands them to the kernel
    qx = torch.randn(B, lq, 3 * H * D, device=dev, generator=gen).to(dtype)
    kvx = torch.randn(B, lk, 3 * H * D, device=dev, generator=gen).to(dtype)
    q = qx[..., :H * D].unflatten(-1, (H, D))
    k, v = (x.unflatten(-1, (H, D)) for x in kvx[..., H * D:].split(H * D, -1))
    if bias_kind == "per_head":
        bias = torch.randn(B, H, lq, lk, device=dev, generator=gen)
    else:
        keep = torch.rand(B, lk, device=dev, generator=gen) < 0.8
        keep[:, 0] = True
        bias = extend_neg_mask(keep)  # [B, 1, 1, Lk]
    scale = D ** -0.5

    before = fused_attention.launches
    got = fused_attention(q, k, v, bias, scale)
    want = attention_reference(q, k, v, bias, scale)
    torch.cuda.synchronize()
    check(fused_attention.launches == before + 1, "the kernel was not launched")
    err = (got.float() - want.float()).abs().max().item()
    tol = KERNEL_TOL[dtype_name]
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"kernel vs plain B{B} {lq}x{lk} {dtype_name} {bias_kind}: "
          f"max abs err {err}")

    # the yardstick: one PyTorch call computing the same function
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = bias.to(dtype)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              scale=scale)

    lib_err = (library().transpose(1, 2).float() - want.float()).abs().max().item()

    # least time: each input read once, the output written once; the two
    # products' operations at the input type's peak
    elt = q.element_size()
    nbytes = (2 * B * lq + 2 * B * lk) * H * D * elt + bias.numel() * 4
    flops = 4 * B * H * lq * lk * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return {
        "B": B, "Lq": lq, "Lk": lk, "dtype": dtype_name, "bias": bias_kind,
        "max_abs_err": err, "tol": tol,
        "ms": time_ms(torch, lambda: fused_attention(q, k, v, bias, scale)),
        "plain_ms": time_ms(torch, lambda: attention_reference(q, k, v, bias,
                                                               scale)),
        "library_ms": time_ms(torch, library),
        "library_max_abs_err": lib_err,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }


def kernels_phase(torch):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [kernel_case(torch, B, lq, lk, dt, bk, gen)
             for B in BATCHES for (lq, lk) in SHAPES
             for dt in ("bfloat16", "float32") for bk in ("mask", "per_head")]
    emit({"phase": "kernels", "cases": cases})
    return cases


def main() -> None:
    if not (ROOT / KERNEL_SOURCE).is_file():
        print("chip_smoke: run it from a checkout of the repository "
              f"({KERNEL_SOURCE} is missing)", file=sys.stderr)
        raise SystemExit(2)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(3)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vln_imagine_tpu_torch.config import hamt_r2r_config
    from vln_imagine_tpu_torch.eval.trace import bench_world
    from vln_imagine_tpu_torch.ops import attention

    t = time.perf_counter()
    lib = attention.load_kernel()
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "library": Path(lib._name).name, "nvcc_flags": attention.NVCC_FLAGS})

    cfg = hamt_r2r_config()
    world = bench_world(cfg)
    launches = main_path_phase(torch, cfg, world)
    check(launches > 0, "the main path launched no attention kernel")
    parity_phase(torch, cfg, world)
    # after the main path, so that its peak memory is its own
    cases = kernels_phase(torch)

    rep = next(c for c in cases
               if (c["B"], c["Lq"], c["Lk"], c["dtype"], c["bias"])
               == REPRESENTATIVE)
    emit({"kernels": [{
        "name": "attention_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
        "at": "B64 Lq67 Lk67 H12 D64 bf16, [B,1,1,Lk] mask, packed q/k/v",
    }]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
