#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`vln_imagine_tpu_torch`).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, each printing one
JSON line and each starting with its own peak memory (`fresh_phase`); any
failed check exits non-zero:

1. build        compile every kernel source (`vln_imagine_tpu_torch/csrc/
                attention_fwd.cu`: K1, K2; `attention_bwd.cu`: K3, K4) with
                nvcc for sm_90a into `build/kernels/`, one nvcc per source,
                all started together, and load them.
2. main_path    HAMT-Imagine greedy eval (`HamtTrainer.make_eval_step`) at the
                released R2R config, full width, bf16, on the synthetic world
                of bench.py (2 scans x 96 nodes x 36 views x 768 features),
                batch 64 and 8, seeded random weights: valid walks, K1's
                launch count (9 + 18 per step, K2-K4 none), episodes/s,
                SR/SPL/nDTW, peak memory.
3. parity       the same weights in f32 at batch 4: the port on the card
                (kernel) against the port on the CPU (plain version):
                identical paths, step-0 logits within LOGIT_TOL.
4. train        the IL + RL train step (`HamtTrainer.make_train_step
                ("sample")`) at the released config, full width, bf16, batch
                8, attention dropout 0.1 on: one warm-up step and three timed
                ones.  Finite losses, grad_norm finite and > 0, stage-1
                semantics (only the aux groups and the critic move, every
                other parameter bitwise unchanged), K2/K3 launches per step
                (`train_launches_per_step`: 448 / 368, K1 and K4 none), ms
                per step, peak memory.
5. train_parity one teacher step in f32 with every dropout off at batch 2,
                full width: the card (K1 forward, K4 backward) against the
                CPU (plain versions): loss and grad_norm within 1e-4
                relative, updated parameters within UPDATE_TOL.
6. duet_eval    DUET-Imagine greedy eval (`DuetTrainer.make_eval_step`) at
                `duet_r2r_config`, full width, bf16, same world, batch 64
                and 8: paths that start at the start node and move along
                edges (a teleport longer than its 6-hop cap records its
                endpoint: counted, not failed), K1's launch count (9 + 18
                per step, K2-K4 none), episodes/s, SR/SPL/nDTW, peak memory.
7. duet_parity  the same in f32 at batch 4, card against CPU: identical
                paths, step-0 fused logits within LOGIT_TOL.
8. duet_train   the DAgger step (`DuetTrainer.make_train_step`: teacher-
                forced IL over 8 steps + sampled student over 15 supervised
                by the SPL expert) at batch 8, every dropout on: one warm-up
                and three timed steps; finite losses, grad_norm > 0, stage-1
                semantics, K2 / K3 launches per step
                (`duet_train_launches_per_step`: 432 / 432), ms per step,
                peak memory.
9. duet_train_parity one f32 'imitation' step, dropout off, batch 2: K1
                forward and K4 backward (dBias into `sprel_linear`) on the
                card against the CPU: loss, grad_norm and the sprel_linear
                gradient within TRAIN_TOL, updates under UPDATE_TOL.
10. driver_hamt / driver_duet: the host side of a run at the released
                config, full width, bf16.  The bench world is written as a
                user's files (connectivity JSON, `R2R_{train,val_unseen}
                _enc.json`, generated-flag and sub-instruction JSON; view and
                imagination features in an `InMemoryFeaturesDB`), read back
                through `construct_instrs` -> `episodes_from_annotations`
                (32 train and 100 val items), and
                `FinetuneDriver.run(iters=4, log_every=2)` trains batch 8
                and validates in batches of 64 (the last wraps).  Gates: logs
                and checkpoints written, finite metrics, K1 launches = sum of
                9 + 18 x steps over the eval batches (the loop's own step
                counts), K2 / K3 = 4 x the train phases' per-step counts, K4
                none; a fresh driver's `load_checkpoint` equals the file
                bitwise; a NaN loss in the first interval rolls back to a
                state bitwise equal to `latest_dict`.  Interval seconds, ms
                per train step, validate episodes/s, checkpoint save / load
                seconds and bytes, peak memory.
11. train_cli   `python -m vln_imagine_tpu_torch.scripts.train --synthetic
                --iters 2 --log-every 1` with no `--device`, in process: it
                runs on the card at the released HAMT preset, writes its
                logs and checkpoints, and launches K1-K3.
12. hamt_train_variants  the HAMT training branches past the released
                recipe (`HAMT_VARIANTS`, after the released recipe itself
                for a baseline in the same phase), each at the released
                config with one change, full width, bf16, batch 8, every
                dropout on: the fused IL + RL rollout at 8 + 8, the InfoNCE
                and margin alignment losses, the full imagination encoder,
                and rangerlars for 6 steps (the critic's Lookahead syncs at
                the sixth).  Gates as
                `train` (K2 / K3 per step from `train_launches_per_step`),
                ms per step, peak memory; then one f32 fused step, dropout
                off, card vs CPU with the same draws (`same_draws`).
13. duet_train_variants  after the released DAgger recipe, DUET's
                `train_alg="rl"` (A2C, the critic moves), DAgger with the
                nDTW expert, with `expl_sample` and with `act_visited_nodes`
                (`DUET_VARIANTS`), gates as `duet_train`;
                then one f32 'rl' step card vs CPU with the same draws.
14. duet_eval_variants  greedy eval under `fusion="local"` and with the
                detailed stop table at batch 64: valid walks, K1 9 + 18 a
                step, each item's stop table, episodes/s.
15. train_cli_duet  `--agent duet --synthetic --detailed-output
                --expl-sample --iters 2 --log-every 1` with no `--device`,
                then the driver's validation with outputs: it writes
                `detail_val_unseen.json` on the card.
16. variants    every task variant at its preset (`VARIANT_PRESETS`), full
                width, bf16, on the bench world with 768-d objects where
                the task grounds them (REVERIE 20 a node, SOON 100):
                REVERIE-DUET, SOON, REVERIE-HAMT (NavRef), r2r_back
                (out-and-back episodes with a midstop), CVDN (the
                shortest-path teacher), RxR (250,002-token vocabulary, 270
                text keys), and R4R of both agents (eval only).  Greedy
                eval at batch 64: valid walks, K1 from the launch formulas
                (`eval_calls`), each predicted object one that its node
                shows, each midstop on its path; then but for R4R the
                preset's train step at batch 8 with every dropout on
                (`variant_steps`: K2 / K3 from `train_launches_per_step`
                or `duet_train_launches_per_step`, stage-1 semantics or,
                for NavRef's plain optimizer, `plain_split`), and a
                positive grounding loss where objects are supervised.
17. reverie_hamt_f32_parity / reverie_duet_f32_parity  NavRef's 'sample'
                step (same draws) and REVERIE-DUET's 'imitation' step, f32,
                batch 2, card vs CPU (`f32_parity`).
18. variant_driver  `FinetuneDriver.validate` of REVERIE-DUET over 100
                items, the object tables built by `build_object_tables`
                from a stand-in of the HDF5 store (`StandInObjectStore`):
                K1 counted from the loop's steps, RGS / RGSPL, a
                `predObjId` per item in the submission.
19. train_cli_r2r_back  the train CLI with `--dataset r2r_back` on files
                written in the ReturnBack layout (`write_run_files`), the
                view features in memory in the HDF5 reader's place;
                `cli_phase`'s gates.
20. vit_extract `FeatureExtractor` (ViT-B/16 at 224, bf16) over 4 batches
                of 64 host images: 12 K1 a batch, images/s from the host
                arrays and device ms a batch, peak memory; the f32 class
                token of 4 images, card vs CPU, within VIT_TOL.
21. e2e_finetune the ViT in the fine-tune step (`e2e_imagination`) at the
                released configs, B 8, 20 imaginations an item (160 images
                a rollout): HAMT 'sample' frozen and trainable, DUET DAgger
                trainable (`variant_steps` with K1 24 and, trainable, K4 24
                a step from the ViT beside the K2 / K3 of the formulas; the
                ViT bitwise unchanged when frozen, moved when trainable);
                HAMT e2e greedy eval at B 64 (1,280 images, K1 9 + 12 + 18
                a step).
22. e2e_train_parity one f32 teacher step with the ViT trainable, B 2,
                card vs CPU (`f32_parity`, with the ViT's qkv gradient).
23. hamt_pretrain `HamtPretrainer` at hamt_r2r_config, B 16, image_prob_size
                1000: a warm-up round, then one step of each of the six
                tasks with K2 / K3 from `pretrain_calls`, ms a step, peak
                memory; `validate` on a held-out split (K1 only); each
                task's f32 loss and gradients, B 2, card vs CPU.
24. e2e_pretrain `E2EPretrainer` with ViT-B/16 224 in the step, B 2,
                max_hist_len 15 (1,080 panorama views a step without
                autograd; `SyntheticPanoramas` makes the bank from a seed):
                one step of each task, K1 / K4 from the ViT calls, K2 / K3
                from `pretrain_calls`, each ViT call's autograd state.
25. duet_pretrain `DuetPretrainer` at duet_r2r_config with
                `use_lang2visn_attn`, B 64, image_prob_size 1000, the bench
                episodes as trajectories: after a warm-up round one step of
                each of mlm, mrc and sap (K2 = K3 = 27, 19, 27 from
                `duet_pretrain_calls`: mrc and og skip the global branch),
                the host's batch assembly and the device's busy time (one
                more step under torch.profiler) beside the step, peak
                memory; `validate` (K1 only); og at the REVERIE-DUET preset
                on the bench world with 20 objects a node, B 8, and its
                `validate`; each task's f32 loss and gradients at B 2, card
                (K1, K4 with dBias into sprel_linear) vs CPU.
26. pretrain_cli `scripts.pretrain --synthetic --steps 4 --log-steps 2
                --valid-steps 2` with no --device: `--agent hamt`, the same
                with `--e2e` (32 px, B 2), and `--agent duet` (the DUET
                preset, B 64), each writing `model_step_4`; then
                `scripts.train --synthetic --iters 2 --init-from-pretrain`
                the HAMT feature run's snapshot and, `--agent duet`, the
                DUET run's: each transfers leaves.
27. kernels     every kernel against its plain PyTorch version on the card:
                K1 at every (Lq, Lk) of the eval path, B 8 and 64, and of
                the teacher step, B 8; K2 (both bit sources), K3 (both) and
                K4 at every training shape, B 8; every kernel also at the
                long shapes 220/220 and 270/270 (the DUET and RxR text
                stacks), K1 and K2 at 80/129 (one key past a staged chunk)
                and at D 32 and 128; bf16 and f32, [B,1,1,Lk] mask and
                per-head bias (dBias checked there), q/k/v as views of a
                packed projection; and at DUET's shapes and bias forms
                (`DUET_SHAPES`: the graph bias [B,1,97,97] with dBias, the
                -1e9 pano key padding), with launch-weighted times per DUET
                step (`duet_weighted`); at the imagination encoder's
                20/20 with one item's keys all masked (`IMAGINE_SHAPE`);
                at the task variants' shapes (`VARIANT_SHAPES`: SOON's
                150/150 and 151/101, REVERIE-DUET's 70/70 and 71/201,
                NavRef's 87/87 and 87/60, RxR's 270/67 and 67/270, CVDN's
                100/100), and at 70/70 with one item's object keys all
                masked (`NO_OBJECTS_SHAPE`); K1 (B 64) and K4 (B 8) at the
                ViT's 197/197 with no bias (`VIT_SHAPE`), q/k/v views of one
                packed qkv product; at DUET pre-training's shapes
                (`DUET_PRETRAIN_SHAPES`: lang2visn's 200/97 and 200/51, K1
                at B 64, K2 / K3 at B 8 and 64; `PANO_ROWS_SHAPE`: every
                kernel at 50/50 over 960 rows, two thirds of them with
                every key masked at -1e9).
                Kernel, plain and library times
                (CUDA-graph replays between CUDA events) beside the least
                time the card could take.  Two K2 calls, and two K3 calls,
                give the same bits.

    python3 chip_smoke.py --parent DIR

also builds DIR's forward source (another checkout, e.g. a `git archive` of
the parent commit) and times its K1/K2 beside this checkout's on the same
inputs, in turns (`parent_ms` in the kernels phase).

Then the kernel summary line `{"kernels": [...]}`, the card's name and power
limit, and last the result line.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = "vln_imagine_tpu_torch/csrc"
KERNEL_SOURCES = (f"{CSRC}/attention_fwd.cu", f"{CSRC}/attention_bwd.cu")
TPU = "vln_imagine_tpu/ops/attention.py"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "attention_fwd": (KERNEL_SOURCES[0], f"{TPU}:57"),          # _fwd_kernel
    "attention_dropout_fwd": (KERNEL_SOURCES[0], f"{TPU}:119"),  # _fwd_dropout_kernel
    "attention_dropout_bwd": (KERNEL_SOURCES[1], f"{TPU}:133"),  # _bwd_dropout_kernel
    "attention_bwd": (KERNEL_SOURCES[1], f"{TPU}:67"),           # _bwd_kernel
}

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# rate of the kernels' arithmetic for their input type (bf16 on tensor
# cores, f32 outside them: TF32 stays off)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel vs plain, both on the card.  f32: the same products summed in
# another order (64-term dot products, <= 80-term sums over keys or query
# rows) differ by ~1e-6; 1e-4 leaves room.  bf16: P and O are rounded to
# bf16 on both sides, so a score one f32 ulp apart can flip P by one bf16
# ulp and O by one (2^-7 at |O| ~ 1); atol and rtol 1e-2 cover about two
# ulps.  The backward's outputs are rounded once, from f32 sums, so the
# same bound holds for them.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# step-0 action logits, f32, card vs CPU: 13 transformer layers of width 768
# on two math libraries (cuBLAS vs the CPU's BLAS)
LOGIT_TOL = 1e-3
# train_parity: loss and grad_norm, f32, card vs CPU, relative
TRAIN_TOL = 1e-4
# train_parity, updated parameters.  In stage 1 Adam's first step moves an
# element by lr*10 * g / (|g| + 1e-8): about 1e-4 in magnitude whatever |g|
# is.  Where |g| is at the level of the card-vs-CPU rounding of the
# gradient, the two may move it differently, up to 2e-4 apart.  So: every
# element within 2 * 1e-4 (plus f32 rounding of the parameter), and all but
# UPDATE_FRACTION of them within 1e-6.
UPDATE_TOL = 1e-6
UPDATE_FRACTION = 1e-3

# (Lq, Lk) of every attention call of HAMT greedy eval at the released
# config: language self 60/60; x-layer cross 80/67 and 67/80, self 80/80
# and 67/67 (80 = 60 text + 20 imagination, 67 = 16 history slots + 51 obs);
# history pano encoder 36/36.  A train step adds the IL rollout's x-layer
# shapes: its 8 steps keep 9 history slots, so 60 visual tokens (80/60,
# 60/80, 60/60)
SHAPES = [(60, 60), (80, 80), (80, 67), (67, 80), (67, 67), (36, 36)]
TRAIN_SHAPES = SHAPES + [(80, 60), (60, 80)]
# the text stacks of DUET (200 + 20 tokens) and RxR HAMT (250 + 20): past
# one staged chunk of 128 keys or queries
LONG_SHAPES = [(220, 220), (270, 270)]
# the forward one key past a chunk (sweep 1 stages K and V again), and at
# the head dims other than the model's
FWD_EDGE_CASES = [(80, 129, 64), (67, 80, 32), (67, 80, 128)]
# DUET's calls at the released config (bias form beside each): language
# 200/200 once an episode; per step the pano encoder 50/50 (-1e9 key
# padding), the global branch's cross 97/220 and self 97/97 (key mask +
# graph bias, [B, 1, 97, 97]), the local branch's cross 51/220 and self
# 51/51 (97 = [stop] + 96 map slots, 51 = [stop] + 14 candidates + 36 views,
# 220 = 200 text + 20 imagination tokens)
DUET_SHAPES = [(200, 200, "mask"), (50, 50, "pad"), (97, 220, "mask"),
               (97, 97, "graph"), (51, 220, "mask"), (51, 51, "mask")]
# HAMT's full imagination encoder (`bypass_imag_encoder=False`): a
# self-attention over max_imagination_len tokens with the -10000 key mask;
# an item without imaginations has every key of its rows masked
IMAGINE_SHAPE = (20, 20, "imagine")
# the task variants' calls past the R2R shapes (bias form beside each):
# SOON's pano encoder over 14 + 36 + 100 tokens and its local branch,
# [stop] + those 150, against 100 + 1 text keys; REVERIE-DUET's 70 pano
# tokens and its local cross over 200 + 1 text keys; NavRef's visual
# stream of 16 history + 51 observation + 20 object tokens and its cross
# over 60 text keys; RxR's crosses between 67 visual and 250 + 20 text
# tokens; CVDN's 80 + 20 text tokens
VARIANT_SHAPES = [(150, 150, "pad"), (151, 101, "mask"), (70, 70, "pad"),
                  (71, 201, "mask"), (87, 87, "mask"), (87, 60, "mask"),
                  (270, 67, "mask"), (67, 270, "mask"), (100, 100, "mask")]
# REVERIE-DUET's pano encoder with one item's 20 object keys all masked
# (its views stay valid)
NO_OBJECTS_SHAPE = (70, 70, "no_objects")
# the ViT-B/16's self-attention at 224 px: [CLS] + 14 x 14 patches, no bias
VIT_SHAPE = (197, 197)
# DUET pre-training's new calls: MLM's lang2visn, the 200 text queries over
# the global branch's 97 and the local branch's 51 keys (-10000 key mask);
# and the pano encoder over every step of 64 end-aligned trajectories of 15
# steps, 960 rows of 50/50 with the -1e9 key padding, the padding steps'
# rows (two thirds) with every key masked
DUET_PRETRAIN_SHAPES = [(200, 97, "mask"), (200, 51, "mask")]
PANO_ROWS, PANO_ROWS_SHAPE = 960, (50, 50, "pad_rows")
DUET_TEXT_CALLS = 9
DUET_STEP_CALLS = {(50, 50): 2, (97, 220): 4, (97, 97): 4, (51, 220): 4,
                   (51, 51): 4}
HEADS, HEAD_DIM = 12, 64
BATCHES = (64, 8)
TRAIN_BATCH = 8
REPRESENTATIVE = {  # the summary line's case per kernel
    "attention_fwd": (64, 67, 67, "bfloat16", "mask"),
    "attention_dropout_fwd": (8, 67, 67, "bfloat16", "mask"),
    "attention_dropout_bwd": (8, 67, 67, "bfloat16", "mask"),
    "attention_bwd": (8, 67, 67, "bfloat16", "mask"),
}
DROPOUT = 0.1  # attention_probs_dropout_prob of the released config


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries `at_s`, the run's seconds when
    the phase ended."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
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


def time_ms(torch, fn, iters: int = 20, repeats: int = 5,
            stream=None) -> float:
    """Device time of one call: `iters` calls captured in a CUDA graph,
    replayed `repeats` times between CUDA events, median over the replays
    divided by `iters`.  The graph keeps the host's launch rate out of the
    number (at B 8 a call takes the device less time than Python takes to
    launch it).  Inputs stay warm in L2, as on the main path, where the
    projection that produced q/k/v ran just before.  `stream`: the capture
    stream, for a backward whose forward ran there (autograd runs each
    backward op on its forward's stream)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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
    del graph
    return statistics.median(times)


def fresh_phase(torch) -> None:
    """Start a phase with its own peak memory: free what earlier phases left
    (trainers held in reference cycles, the caching allocator's blocks),
    then reset the peak.  Every phase calls it first."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


# --------------------------------------------------------------- phase 2
def check_walks(world, ep, nodes, lens, max_len, jumps_allowed=False) -> int:
    """Every path starts at its start node, has at most `max_len` entries of
    valid nodes, and each move follows a valid edge of `adj`.  With
    `jumps_allowed` (DUET, whose teleport records at most 6 hops and then
    the endpoint itself) a move may skip, to a node other than the one it
    leaves; returns the number of such moves."""
    import numpy as np

    adj, adj_valid = np.asarray(world.adj), np.asarray(world.adj_valid)
    node_valid = np.asarray(world.node_valid)
    scan, start = np.asarray(ep.scan), np.asarray(ep.start_node)
    jumps = 0
    for b in range(len(lens)):
        n = int(lens[b])
        check(1 <= n <= max_len, f"item {b}: path length {n}")
        path = nodes[b, :n]
        check(path[0] == start[b], f"item {b}: path does not start at start")
        check(node_valid[scan[b], path].all(), f"item {b}: invalid node")
        for a, c in zip(path[:-1], path[1:]):
            nbrs = adj[scan[b], a][adj_valid[scan[b], a]]
            if c not in nbrs:
                check(jumps_allowed and c != a,
                      f"item {b}: {a} -> {c} is not an edge")
                jumps += 1
    return jumps


def main_path_phase(torch, cfg, world):
    import numpy as np

    from vln_imagine_tpu_torch.eval.metrics import (
        eval_batch,
        trajectories_from_rollout,
    )
    from vln_imagine_tpu_torch.eval.trace import bench_episodes
    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.train.trainer import HamtTrainer

    fresh_phase(torch)
    T = cfg.env.max_action_len
    # attention calls: one per language layer once per episode; per step,
    # four per cross-modal layer and one per history pano layer (9 + 18 at
    # the released config)
    per_episode, per_step = eval_calls(cfg)
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
    attention.reset_launch_counts()
    runs = {}
    for B in BATCHES:
        before = attention.attention_fwd.launches
        nodes, lens = eval_step(eps[B])
        nodes, lens = nodes.cpu().numpy(), lens.cpu().numpy()
        runs[B] = (nodes, lens, attention.attention_fwd.launches - before)
    launches = attention.launch_counts()
    check(launches["attention_fwd"] > 0 and sum(launches.values())
          == launches["attention_fwd"], f"eval launches {launches}")

    results = []
    for B in BATCHES:
        nodes, lens, count = runs[B]
        ep, ep_np = eps[B], eps_np[B]
        check_walks(world, ep_np, nodes, lens, T + 1)
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
          "setup_s": setup_s, "launches": launches, "runs": results})
    del trainer
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- phase 3
def parity_phase(torch, cfg, world):
    import numpy as np

    from vln_imagine_tpu_torch.config import _replace
    from vln_imagine_tpu_torch.eval.trace import bench_episodes
    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.train.rollout_hamt import rollout_hamt
    from vln_imagine_tpu_torch.train.trainer import HamtTrainer

    fresh_phase(torch)
    cfg32 = _replace(cfg, "model", compute_dtype="float32")
    ep = bench_episodes(world, cfg32, 4)
    out = {}
    for dev in ("cuda", "cpu"):
        trainer = HamtTrainer(cfg32, world, device=dev)
        before = attention.attention_fwd.launches
        nodes, lens = trainer.make_eval_step()(ep)
        step0 = rollout_hamt(trainer.model, trainer.tables, ep.to(dev), cfg32,
                             max_steps=1, early_exit=False).logits[0]
        launched = attention.attention_fwd.launches - before
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
def hamt_calls(cfg) -> tuple[int, int, int, int]:
    """Attention calls of one HAMT rollout: (language stack, imagination
    encoder) once an episode, (cross-modal layers, history pano encoder)
    per step.  The language stack is `num_l_layers`, plus each x-layer's
    language branch under no_lang_ca, but not NavRef's (objects), whose
    text skips the x-layers; the full imagination encoder
    (`bypass_imag_encoder=False`) is `num_pano_layers`; an x-layer makes 4
    calls, 2 when the text stays static (no_lang_ca)."""
    m = cfg.model
    lang = m.num_l_layers + (m.num_x_layers if m.no_lang_ca
                             and m.obj_feat_size == 0 else 0)
    imagine = (m.num_pano_layers if m.imagine_enc_pano
               and not m.bypass_imag_encoder else 0)
    x = (2 if m.no_lang_ca else 4) * m.num_x_layers
    return lang, imagine, x, m.num_pano_layers


def train_launches_per_step(cfg) -> tuple[int, int]:
    """K2 and K3 launches of one 'sample' step: every attention call has
    dropout on (K2).  IL rollout (over min(max_gt_path_len, max_action_len)
    steps, cvdn's shortest-path teacher over max_action_len): the language
    stack once, then per step the cross-modal and pano calls; the RL
    rollout the same over max_action_len steps plus the final-state visual
    call (the cross-modal calls).  With `fused_sample_rollout` one rollout
    of max_action_len steps does both.  Backward (K3): the x-layer calls,
    the imagination encoder's unless fix_imagine_embeds, the language
    stack's unless fix_lang_embedding, and the pano encoder's unless
    fix_hist_embedding, save the last step's, whose history token no later
    call reads; the final-state value is under stop-gradient."""
    m, e = cfg.model, cfg.env
    t_rl = e.max_action_len
    t_il = t_rl if cfg.dataset == "cvdn" else min(e.max_gt_path_len, t_rl)
    lang, imagine, x, pano = hamt_calls(cfg)
    rollouts = [t_rl] if cfg.train.fused_sample_rollout else [t_il, t_rl]
    k2 = sum(lang + imagine + t * (x + pano) for t in rollouts) + x
    k3 = sum(x * t + (0 if m.fix_imagine_embeds else imagine)
             + (0 if m.fix_lang_embedding else lang)
             + (0 if m.fix_hist_embedding else pano * (t - 1))
             for t in rollouts)
    return k2, k3


def train_phase(torch, cfg, world):
    from vln_imagine_tpu_torch.eval.trace import bench_episodes
    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.train.optim import label_hamt_param
    from vln_imagine_tpu_torch.train.trainer import HamtTrainer

    check(cfg.model.fix_lang_embedding and cfg.model.fix_hist_embedding
          and cfg.model.attention_probs_dropout_prob > 0,
          "the released config fixes the language and history embeddings "
          "and trains with attention dropout")
    fresh_phase(torch)
    k2_want, k3_want = train_launches_per_step(cfg)
    t0 = time.perf_counter()
    trainer = HamtTrainer(cfg, world, device="cuda")
    ep = bench_episodes(world, cfg, TRAIN_BATCH).to("cuda")
    model0 = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    critic0 = {k: v.clone() for k, v in trainer.critic.state_dict().items()}
    step = trainer.make_train_step("sample")
    step(ep, ep)  # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    attention.reset_launch_counts()
    times, metrics, counts = [], [], []
    for _ in range(3):
        before = attention.launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        m = step(ep, ep)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        metrics.append({k: float(v) for k, v in m.items()})
        after = attention.launch_counts()
        counts.append({k: after[k] - before[k] for k in after})
    launches = attention.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    for m in metrics:
        check(all(math.isfinite(v) for v in m.values()), f"train metrics {m}")
        check(m["grad_norm"] > 0, f"grad_norm {m['grad_norm']}")
    for c in counts:
        check(c == {"attention_fwd": 0, "attention_dropout_fwd": k2_want,
                    "attention_dropout_bwd": k3_want, "attention_bwd": 0},
              f"launches per train step {c}, expected K2 {k2_want} and K3 "
              f"{k3_want} only")
    moved, still = [], []
    for name, v in trainer.model.state_dict().items():
        (still if torch.equal(v, model0[name]) else moved).append(name)
    check(all(label_hamt_param(n) == "rest" for n in still)
          and all(label_hamt_param(n) != "rest" for n in moved),
          f"stage 1: moved {[n for n in moved if label_hamt_param(n) == 'rest'][:5]}, "
          f"still {[n for n in still if label_hamt_param(n) != 'rest'][:5]}")
    check(all(not torch.equal(v, critic0[k])
              for k, v in trainer.critic.state_dict().items()),
          "the critic did not move")
    emit({"phase": "train", "config": "hamt_r2r_config", "feedback": "sample",
          "compute_dtype": cfg.model.compute_dtype, "batch": TRAIN_BATCH,
          "params": sum(p.numel() for p in trainer.model.parameters()),
          "critic_params": sum(p.numel() for p in trainer.critic.parameters()),
          "setup_s": setup_s, "step_ms": statistics.median(times),
          "step_ms_all": times, "peak_mem_bytes": peak, "metrics": metrics,
          "launches_per_step": counts[0], "launches": launches,
          "expected_per_step": {"attention_dropout_fwd": k2_want,
                                "attention_dropout_bwd": k3_want},
          "params_moved": len(moved), "params_unchanged": len(still)})
    del trainer, model0, critic0
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- phase 5
PARITY_DRAW_SEED = 7


@contextlib.contextmanager
def same_draws(torch, module):
    """Within the block, `module.sample_categorical` takes its Gumbel noise
    from one CPU generator seeded PARITY_DRAW_SEED, so that the card and the
    CPU draw the same actions from (nearly) the same log-probabilities."""
    gen = torch.Generator().manual_seed(PARITY_DRAW_SEED)

    def draw(logp, generator):
        u = torch.rand(logp.shape, generator=gen).to(logp.device)
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return torch.argmax(logp + g, dim=-1)

    orig, module.sample_categorical = module.sample_categorical, draw
    try:
        yield
    finally:
        module.sample_categorical = orig


def cfg_f32(cfg, **train):
    """`cfg` in f32 with every dropout of the config off."""
    from vln_imagine_tpu_torch.config import _replace

    cfg = _replace(cfg, "model", compute_dtype="float32",
                   hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                   pred_head_dropout_prob=0.0)
    return _replace(cfg, "train", feat_dropout=0.0, **train)


def f32_parity(torch, phase, make_trainer, make_step, keys, lr, draws=None,
               grads=None, **fields):
    """One f32 train step, every dropout off, on the card and on the CPU:
    `make_trainer(device)` gives (trainer, episodes), `make_step(trainer)`
    the step; with `draws` (a rollout module) both sides draw the same
    actions (`same_draws`).  Emits `phase` (with `fields`), then gates: K1
    and K4 only on the card; the metrics `keys` and the gradients that
    `grads(trainer)` names within TRAIN_TOL relative; every updated element
    within 2 * lr * 10 and all but UPDATE_FRACTION of the moved ones within
    UPDATE_TOL.  Returns the card's launches."""
    from vln_imagine_tpu_torch.ops import attention

    fresh_phase(torch)
    out, launches = {}, None
    for dev in ("cuda", "cpu"):
        trainer, ep = make_trainer(dev)
        # the alignment head's fixed 0.15 dropout and the critic's 0.5, off
        # on both sides
        if hasattr(trainer.model, "contrastive_alignment_model"):
            trainer.model.contrastive_alignment_model.image_proj.rate = 0.0
        if trainer.critic is not None:
            trainer.critic.rate = 0.0
        before = {k: v.detach().cpu().clone()
                  for k, v in trainer.model.named_parameters()}
        step = make_step(trainer)
        attention.reset_launch_counts()
        with (contextlib.nullcontext() if draws is None
              else same_draws(torch, draws)):
            m = step(ep, ep)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = attention.launch_counts()
        out[dev] = ({k: float(v) for k, v in m.items()},
                    {k: v.detach().cpu() - before[k]
                     for k, v in trainer.model.named_parameters()},
                    {k: g.detach().cpu()
                     for k, g in ({} if grads is None
                                  else grads(trainer)).items()})
        del trainer
    torch.cuda.empty_cache()
    (gm, gu, gg), (cm, cu, cg) = out["cuda"], out["cpu"]
    rel = {k: abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-30) for k in keys}
    for k, c in cg.items():
        rel[k] = float((gg[k] - c).abs().max() / c.abs().max().clamp_min(1e-30))
    worst, n_off, n_all = 0.0, 0, 0
    for name in cu:
        d = (gu[name] - cu[name]).abs()
        worst = max(worst, float(d.max()))
        n_off += int((d > UPDATE_TOL).sum())
        n_all += d.numel()
    moved = sum(int((u != 0).sum()) for u in cu.values())
    emit({"phase": phase, "compute_dtype": "float32", **fields, "card": gm,
          "cpu": cm, "rel_err": rel, "tol": TRAIN_TOL, "launches": launches,
          "update_max_abs_err": worst, "update_elements_off": n_off,
          "update_elements": n_all, "elements_moved": moved,
          "update_tol": UPDATE_TOL, "update_fraction": UPDATE_FRACTION})
    check(launches["attention_fwd"] > 0 and launches["attention_bwd"] > 0
          and launches["attention_dropout_fwd"] == 0
          and launches["attention_dropout_bwd"] == 0,
          f"{phase} launches {launches}")
    for k, c in cg.items():
        check(float(c.abs().max()) > 0, f"{phase}: no gradient reached {k}")
    check(all(r <= TRAIN_TOL for r in rel.values()), f"{phase}: card vs CPU {rel}")
    check(moved > 0, f"{phase}: no parameter moved")
    check(worst <= 2.0 * lr * 10.0 + 1e-6 and n_off <= UPDATE_FRACTION * moved,
          f"{phase}: updates differ: max {worst}, {n_off} of {moved} moved "
          f"elements beyond {UPDATE_TOL}")
    return launches


def train_parity_phase(torch, cfg, world):
    """One HAMT teacher step, f32, batch 2, card vs CPU (`f32_parity`)."""
    from vln_imagine_tpu_torch.eval.trace import bench_episodes
    from vln_imagine_tpu_torch.train.trainer import HamtTrainer

    cfg32 = cfg_f32(cfg)
    return f32_parity(
        torch, "train_parity",
        lambda dev: (HamtTrainer(cfg32, world, device=dev),
                     bench_episodes(world, cfg32, 2)),
        lambda tr: tr.make_train_step("teacher"),
        ("loss", "grad_norm", "ml_loss", "aux_loss"), cfg.train.lr,
        batch=2, feedback="teacher")


# --------------------------------------------------------------- DUET
def duet_calls(cfg) -> tuple[int, int]:
    """Attention calls of one DUET rollout: one per language layer once,
    then per step one per pano encoder layer and two per cross-modal layer
    (cross, self) in each of the two branches (9, and 2 + 16 = 18, at the
    released config)."""
    m = cfg.model
    return m.num_l_layers, m.num_pano_layers + 2 * 2 * m.num_x_layers


def duet_train_launches_per_step(cfg) -> tuple[int, int]:
    """K2 and K3 launches of one DAgger step: the teacher-forced rollout
    over min(max_gt_path_len, max_action_len) steps and the student rollout
    over max_action_len steps, each with its language stack; every call has
    dropout on (K2), and every call reaches the loss with a gradient (K3),
    since the DUET recipe fixes neither the language nor the pano stack."""
    m, e = cfg.model, cfg.env
    check(not (m.fix_lang_embedding or m.fix_pano_embedding
               or m.fix_local_branch) and m.update_lang_bert,
          "the DUET recipe trains every stack")
    per_episode, per_step = duet_calls(cfg)
    t_il, t_dg = min(e.max_gt_path_len, e.max_action_len), e.max_action_len
    k2 = 2 * per_episode + (t_il + t_dg) * per_step
    return k2, k2


def duet_eval_phase(torch, cfg, world):
    import numpy as np

    from vln_imagine_tpu_torch.eval.metrics import (
        eval_batch,
        trajectories_from_rollout,
    )
    from vln_imagine_tpu_torch.eval.trace import bench_episodes, eval_steps
    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.train.rollout_duet import path_buffer_len
    from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

    fresh_phase(torch)
    per_episode, per_step = duet_calls(cfg)
    t0 = time.perf_counter()
    trainer = DuetTrainer(cfg, world, device="cuda")
    eval_step = trainer.make_eval_step()
    eps_np = {B: bench_episodes(world, cfg, B) for B in BATCHES}
    eps = {B: eps_np[B].to("cuda") for B in BATCHES}
    for B in BATCHES:  # warm-up
        eval_step(eps[B])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # the counted run: every count set to 0 just before, read just after
    attention.reset_launch_counts()
    runs = {}
    for B in BATCHES:
        before = attention.attention_fwd.launches
        nodes, lens = eval_step(eps[B])
        runs[B] = (nodes.cpu().numpy(), lens.cpu().numpy(),
                   attention.attention_fwd.launches - before)
    launches = attention.launch_counts()
    check(launches["attention_fwd"] > 0 and sum(launches.values())
          == launches["attention_fwd"], f"duet eval launches {launches}")

    results = []
    for B in BATCHES:
        nodes, lens, count = runs[B]
        ep, ep_np = eps[B], eps_np[B]
        jumps = check_walks(world, ep_np, nodes, lens, path_buffer_len(cfg),
                            jumps_allowed=True)
        steps = eval_steps(trainer, ep, None)
        want = per_episode + per_step * steps
        check(count == want, f"duet batch {B}: {count} attention launches "
              f"for {steps} steps, expected {want}")
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t = time.perf_counter()
            out = eval_step(ep)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            check(np.array_equal(out[0].cpu().numpy(), nodes),
                  f"duet batch {B}: greedy paths differ between runs")
        dt = statistics.median(times)
        gt = [list(p[:n]) for p, n in zip(ep_np.gt_path, ep_np.gt_len)]
        summary, _ = eval_batch(np.asarray(world.dist), ep_np.scan,
                                trajectories_from_rollout(nodes, lens), gt)
        results.append({
            "batch": B, "steps": steps, "attention_launches": count,
            "episodes_per_s": B / dt, "episode_batch_ms": dt * 1e3,
            "episode_batch_ms_all": [x * 1e3 for x in times],
            "path_len_max": int(lens.max()), "non_edge_moves": jumps,
            "sr": summary["sr"], "spl": summary["spl"],
            "nDTW": summary["nDTW"],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        })
    emit({"phase": "duet_eval", "config": "duet_r2r_config",
          "compute_dtype": cfg.model.compute_dtype,
          "params": sum(p.numel() for p in trainer.model.parameters()),
          "setup_s": setup_s, "launches": launches, "runs": results})
    del trainer
    torch.cuda.empty_cache()
    return launches


def duet_parity_phase(torch, cfg, world):
    import numpy as np

    from vln_imagine_tpu_torch.config import _replace
    from vln_imagine_tpu_torch.eval.trace import bench_episodes
    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.train.rollout_duet import rollout_duet
    from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

    fresh_phase(torch)
    cfg32 = _replace(cfg, "model", compute_dtype="float32")
    ep = bench_episodes(world, cfg32, 4)
    out = {}
    for dev in ("cuda", "cpu"):
        trainer = DuetTrainer(cfg32, world, device=dev)
        before = attention.attention_fwd.launches
        nodes, lens = trainer.make_eval_step()(ep)
        step0 = rollout_duet(trainer.model, trainer.tables, ep.to(dev), cfg32,
                             max_steps=1).logits[0]
        launched = attention.attention_fwd.launches - before
        check(launched > 0 if dev == "cuda" else launched == 0,
              f"duet {dev}: {launched} kernel launches")
        out[dev] = (nodes.cpu().numpy(), lens.cpu().numpy(),
                    step0.float().cpu().numpy())
        del trainer
    torch.cuda.empty_cache()
    (gn, gl, glog), (cn, cl, clog) = out["cuda"], out["cpu"]
    valid = clog > -1e8
    check(np.array_equal(valid, glog > -1e8), "duet: masked logit slots differ")
    err = float(np.abs(glog[valid] - clog[valid]).max())
    same = bool(np.array_equal(gn, cn) and np.array_equal(gl, cl))
    emit({"phase": "duet_parity", "compute_dtype": "float32", "batch": 4,
          "paths_identical": same, "path_len": gl.tolist(),
          "step0_fused_logit_max_abs_err": err, "tol": LOGIT_TOL})
    check(same, "duet greedy paths differ between the card and the CPU")
    check(err <= LOGIT_TOL, f"duet step-0 fused logits differ by {err}")


def duet_train_phase(torch, cfg, world):
    from vln_imagine_tpu_torch.eval.trace import bench_episodes
    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.train.optim import label_hamt_param
    from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

    check(cfg.train.train_alg == "dagger"
          and cfg.model.attention_probs_dropout_prob > 0,
          "the DUET recipe trains by DAgger with attention dropout")
    fresh_phase(torch)
    k2_want, k3_want = duet_train_launches_per_step(cfg)
    t0 = time.perf_counter()
    trainer = DuetTrainer(cfg, world, device="cuda")
    ep = bench_episodes(world, cfg, TRAIN_BATCH).to("cuda")
    model0 = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    step = trainer.make_train_step()
    step(ep, ep)  # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    attention.reset_launch_counts()
    times, metrics, counts = [], [], []
    for _ in range(3):
        before = attention.launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        m = step(ep, ep)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        metrics.append({k: float(v) for k, v in m.items()})
        after = attention.launch_counts()
        counts.append({k: after[k] - before[k] for k in after})
    launches = attention.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    for m in metrics:
        check(all(math.isfinite(v) for v in m.values()), f"duet metrics {m}")
        check(m["grad_norm"] > 0, f"duet grad_norm {m['grad_norm']}")
    for c in counts:
        check(c == {"attention_fwd": 0, "attention_dropout_fwd": k2_want,
                    "attention_dropout_bwd": k3_want, "attention_bwd": 0},
              f"launches per DAgger step {c}, expected K2 {k2_want} and K3 "
              f"{k3_want} only")
    moved, still = [], []
    for name, v in trainer.model.state_dict().items():
        (still if torch.equal(v, model0[name]) else moved).append(name)
    check(all(label_hamt_param(n) == "rest" for n in still)
          and all(label_hamt_param(n) != "rest" for n in moved),
          f"duet stage 1: moved "
          f"{[n for n in moved if label_hamt_param(n) == 'rest'][:5]}, still "
          f"{[n for n in still if label_hamt_param(n) != 'rest'][:5]}")
    emit({"phase": "duet_train", "config": "duet_r2r_config",
          "train_alg": cfg.train.train_alg,
          "compute_dtype": cfg.model.compute_dtype, "batch": TRAIN_BATCH,
          "params": sum(p.numel() for p in trainer.model.parameters()),
          "setup_s": setup_s, "step_ms": statistics.median(times),
          "step_ms_all": times, "peak_mem_bytes": peak, "metrics": metrics,
          "launches_per_step": counts[0], "launches": launches,
          "expected_per_step": {"attention_dropout_fwd": k2_want,
                                "attention_dropout_bwd": k3_want},
          "params_moved": len(moved), "params_unchanged": len(still)})
    del trainer, model0
    torch.cuda.empty_cache()
    return launches


def duet_train_parity_phase(torch, cfg, world):
    """One DUET 'imitation' step, f32, batch 2, card vs CPU (`f32_parity`),
    with the gradient that K4's dBias carries into `sprel_linear`."""
    from vln_imagine_tpu_torch.eval.trace import bench_episodes
    from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

    cfg32 = cfg_f32(cfg, train_alg="imitation")

    def sprel_grad(tr):
        sprel = tr.model.global_encoder.sprel_linear
        return {"sprel_linear_grad": torch.cat([sprel.weight.grad.flatten(),
                                                sprel.bias.grad.flatten()])}

    return f32_parity(
        torch, "duet_train_parity",
        lambda dev: (DuetTrainer(cfg32, world, device=dev),
                     bench_episodes(world, cfg32, 2)),
        lambda tr: tr.make_train_step(),
        ("loss", "grad_norm", "ml_loss", "aux_loss"), cfg.train.lr,
        grads=sprel_grad, batch=2, train_alg="imitation")


# --------------------------------------------------------------- the driver
DRIVER_TRAIN_PATHS, DRIVER_VAL_PATHS = 16, 100  # 32 train, 100 val items
DRIVER_ITERS, DRIVER_LOG_EVERY = 4, 2


def eval_calls(cfg) -> tuple[int, int]:
    """Attention calls of one greedy-eval rollout: once per episode, and
    per step (9 and 18 at either released config)."""
    if cfg.agent == "duet":
        return duet_calls(cfg)
    lang, imagine, x, pano = hamt_calls(cfg)
    return lang + imagine, x + pano


def write_run_files(cfg, graphs, ep, root: Path, dataset="r2r") -> dict:
    """The world as a user's run would find it on disk: MP3D connectivity
    JSON, `R2R_{train,val_unseen}_enc.json` (two instructions a train path,
    one a val path; under `ReturnBack/` with each item's midstop for
    r2r_back), the generated-flag and sub-instruction JSON.  Returns the
    imagination features by instruction id, for an in-memory store."""
    import numpy as np

    rng = np.random.default_rng(3)
    conn, anno = root / "connectivity", root / "annotations"
    conn.mkdir(parents=True)
    if dataset == "r2r_back":
        anno = anno / "ReturnBack"
    anno.mkdir(parents=True)
    for g in graphs:
        n = g.num_nodes
        unob = [[False] * n for _ in range(n)]
        for a, b in g.edges:
            unob[a][b] = unob[b][a] = True
        items = []
        for i, vid in enumerate(g.node_ids):
            pose = [1.0 if k in (0, 5, 10, 15) else 0.0 for k in range(16)]
            pose[3], pose[7], pose[11] = map(float, g.xyz[i])
            items.append({"image_id": vid, "pose": pose, "included": True,
                          "unobstructed": unob[i]})
        (conn / f"{g.scan_id}_connectivity.json").write_text(json.dumps(items))
    flags, subs, imagine = {}, [], {}
    splits = {"train": (range(DRIVER_TRAIN_PATHS), 2),
              "val_unseen": (range(DRIVER_TRAIN_PATHS, DRIVER_TRAIN_PATHS
                                   + DRIVER_VAL_PATHS), 1)}
    for split, (rows, n_instr) in splits.items():
        items = []
        for b in rows:
            g = graphs[int(ep.scan[b])]
            enc = [int(t) for t in ep.txt_ids[b][ep.txt_mask[b]]]
            items.append({
                "scan": g.scan_id, "path_id": b, "heading":
                    float(ep.start_heading[b]),
                "path": [g.node_ids[int(v)]
                         for v in ep.gt_path[b, :int(ep.gt_len[b])]],
                "instructions": ["walk past the sofa and stop."] * n_instr,
                "instr_encodings": [enc, enc[:len(enc) // 2 + 1]][:n_instr]})
            if dataset == "r2r_back":
                items[-1]["midstop"] = g.node_ids[int(ep.midstop[b])]
            for j in range(n_instr):
                iid = f"{b}_{j}"
                n = int(rng.integers(1, 4))
                flags[iid] = ["True" if rng.random() < 0.8 else "False"
                              for _ in range(n)]
                imagine[iid] = (0.4 * rng.standard_normal(
                    (flags[iid].count("True"), cfg.model.hidden_size))
                    ).astype(np.float32)
                subs.append({"instruction_id": iid,
                             "instr_segmentation_indices": [[1, 4]] * n,
                             "noun_phrase_indices": [[[2, 3]]] * n})
        (anno / f"R2R_{split}_enc.json").write_text(json.dumps(items))
    (root / "generated_flags.json").write_text(json.dumps(flags))
    (root / "sub_instr.json").write_text(json.dumps(subs))
    return imagine


def build_run_data(cfg, world, root: Path, imagine: dict):
    """What the train CLI's `build_real` does, with the features in memory
    (`InMemoryFeaturesDB`): the world compiled from the connectivity JSON,
    the splits built by `construct_instrs` -> `episodes_from_annotations`."""
    from vln_imagine_tpu_torch.data.annotations import (
        AuxMetadata,
        construct_instrs,
        episodes_from_annotations,
    )
    from vln_imagine_tpu_torch.data.features import (
        InMemoryFeaturesDB,
        build_feature_table,
        build_imagination_arrays,
    )
    from vln_imagine_tpu_torch.driver import SplitData
    from vln_imagine_tpu_torch.envx.compiler import (
        compile_world,
        load_connectivity,
    )

    graphs = load_connectivity(str(root / "connectivity"), ["scan0", "scan1"])
    views = InMemoryFeaturesDB({
        f"{g.scan_id}_{vp}": world.feat[s, i]
        for s, g in enumerate(graphs) for i, vp in enumerate(g.node_ids)})
    tables = compile_world(
        graphs, max_candidates=cfg.env.max_candidates, views=cfg.env.views,
        feat=build_feature_table(views, graphs, cfg.env.views,
                                 cfg.model.image_feat_size))
    meta = AuxMetadata.load(str(root / "sub_instr.json"),
                            str(root / "generated_flags.json"))
    splits = []
    for name in ("train", "val_unseen"):
        items = construct_instrs(str(root / "annotations"), "r2r", [name])
        feats, _ = build_imagination_arrays(
            InMemoryFeaturesDB(imagine), [it["instr_id"] for it in items],
            meta.generated_flags, cfg.model.max_imagination_len,
            cfg.model.hidden_size)
        ep, ids = episodes_from_annotations(
            items, graphs, meta, cfg.env.max_instr_len,
            cfg.env.max_gt_path_len, cfg.model.max_imagination_len, feats,
            imagine_feat_dim=cfg.model.hidden_size)
        splits.append(SplitData(name, ep, ids))
    return tables, graphs, splits


def scratch_dir():
    """A directory under build/ for one phase's files, checkpoints of
    gigabytes among them; it goes when the phase ends."""
    (ROOT / "build").mkdir(exist_ok=True)
    return tempfile.TemporaryDirectory(dir=ROOT / "build",
                                       prefix="chip_smoke_")


def states_equal(torch, a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(states_equal(torch, a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(states_equal(torch, x, y) for x, y in zip(a, b)))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.shape == b.shape and torch.equal(a, b)
    return a == b


def driver_phase(torch, cfg, scratch: Path):
    """`FinetuneDriver.run(iters=4, log_every=2)` of the agent's released
    recipe on files written from the bench world; then a fresh driver's
    `load_checkpoint`, and a NaN injected into its first interval."""
    import numpy as np

    from vln_imagine_tpu_torch.driver import FinetuneDriver
    from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
    from vln_imagine_tpu_torch.ops import attention

    fresh_phase(torch)
    agent = cfg.agent
    root = scratch / f"driver_{agent}"
    t_phase = t0 = time.perf_counter()
    # bench_world's arguments: the same world, with its graphs
    world, graphs = synthetic_world(
        num_scans=2, num_nodes=96, max_candidates=cfg.env.max_candidates,
        views=36, feat_dim=cfg.model.image_feat_size, seed=0)
    ep = synthetic_episodes(
        world, batch=DRIVER_TRAIN_PATHS + DRIVER_VAL_PATHS,
        max_gt_path_len=cfg.env.max_gt_path_len,
        max_instr_len=cfg.env.max_instr_len,
        max_imaginations=cfg.model.max_imagination_len,
        vocab_size=cfg.model.vocab_size, feat_dim=cfg.model.hidden_size,
        seed=1)
    imagine = write_run_files(cfg, graphs, ep, root)
    tables, graphs, (train, val) = build_run_data(cfg, world, root, imagine)
    check(np.array_equal(tables.adj, world.adj)
          and np.array_equal(tables.feat, world.feat),
          f"{agent}: the tables compiled from the files differ from the world")
    data_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    d = FinetuneDriver(cfg, tables, train, [val], str(root / "run"),
                       graphs=graphs, device="cuda")
    d.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # the counted run: every count set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    attention.reset_launch_counts()
    t0 = time.perf_counter()
    d.run(iters=DRIVER_ITERS, log_every=DRIVER_LOG_EVERY)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = attention.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    per_episode, per_step = eval_calls(cfg)
    k2, k3 = (train_launches_per_step(cfg) if agent == "hamt"
              else duet_train_launches_per_step(cfg))
    want = {"attention_fwd": sum(per_episode + per_step * s
                                 for s in d.eval_step_counts),
            "attention_dropout_fwd": DRIVER_ITERS * k2,
            "attention_dropout_bwd": DRIVER_ITERS * k3, "attention_bwd": 0}
    check(launches == want, f"{agent} driver launches {launches}, expected "
          f"{want} ({len(d.eval_step_counts)} eval batches, steps "
          f"{d.eval_step_counts})")
    log = root / "run"
    for name in ("train.txt", "metrics.jsonl", "training_args.json",
                 "ckpts/latest_dict", "ckpts/best_val_unseen",
                 "ckpts/best_val_unseen.json"):
        check((log / name).is_file(), f"{agent} driver wrote no {name}")
    records = [json.loads(x) for x in
               (log / "metrics.jsonl").read_text().splitlines()]
    check(len(records) > 0 and all(math.isfinite(r["value"])
                                   for r in records),
          f"{agent} driver: non-finite metrics")
    saves = [e for e in d.ckpt.events if e["op"] == "save"]
    train_t, val_t = d.timings["train"], d.timings["validate"]
    eval_steps = list(d.eval_step_counts)
    del d
    torch.cuda.empty_cache()

    # a fresh driver restores the saved state bitwise
    d2 = FinetuneDriver(cfg, tables, train, [val], str(root / "fresh"),
                        graphs=graphs, device="cuda")
    d2.setup()
    latest = str(log / "ckpts" / "latest_dict")
    d2.load_checkpoint(latest)
    torch.cuda.synchronize()
    load = d2.ckpt.events[-1]
    saved = torch.load(latest, map_location="cuda", weights_only=True)
    check(states_equal(torch, d2.state_dict(), saved),
          f"{agent}: a fresh driver's load_checkpoint differs from the file")
    del saved

    # a NaN loss in the first interval rolls back to latest_dict
    orig, trained = d2.train_interval, {}

    def poisoned(n_iters):
        out = dict(orig(n_iters))
        trained["steps"] = d2.trainer.optimizer.steps
        out["loss"] = float("nan")
        return out

    d2.train_interval = poisoned
    d2.run(iters=DRIVER_LOG_EVERY, log_every=DRIVER_LOG_EVERY, max_failures=1)
    rolled = (root / "fresh" / "train.txt").read_text()
    saved = torch.load(str(root / "fresh" / "ckpts" / "latest_dict"),
                       map_location="cuda", weights_only=True)
    check(trained.get("steps", 0) > saved["vln_bert"]["optimizer"]["steps"]
          and "rolled back to latest_dict" in rolled
          and states_equal(torch, d2.state_dict(), saved),
          f"{agent}: the NaN interval did not roll back to latest_dict")
    del d2, saved
    torch.cuda.empty_cache()

    emit({"phase": f"driver_{agent}", "config": f"{agent}_r2r_config",
          "phase_s": time.perf_counter() - t_phase,
          "compute_dtype": cfg.model.compute_dtype,
          "train_items": int(train.episodes.scan.shape[0]),
          "val_items": int(val.episodes.scan.shape[0]),
          "batch": cfg.train.batch_size,
          "eval_batch": cfg.train.eval_batch_size, "iters": DRIVER_ITERS,
          "log_every": DRIVER_LOG_EVERY, "data_s": data_s,
          "setup_s": setup_s, "run_s": run_s,
          "interval_s": [t["seconds"] for t in train_t],
          "train_step_ms": [t["seconds"] / t["iters"] * 1e3 for t in train_t],
          "validate_s": [t["seconds"] for t in val_t],
          "validate_episodes_per_s": [t["items"] / t["seconds"]
                                      for t in val_t],
          "eval_steps": eval_steps,
          "checkpoint_saves": saves, "checkpoint_load": load,
          "peak_mem_bytes": peak, "launches": launches, "expected": want,
          "rollback": "held", "fresh_load": "bitwise"})
    return launches


CLI_FILES = ("train.txt", "metrics.jsonl", "ckpts/latest_dict",
             "ckpts/best_val_unseen")


def cli_phase(torch, scratch: Path, phase, argv, files=CLI_FILES,
              after=None):
    """The train CLI on the card, as a user runs it, with no --device:
    `argv` in process, then `after(driver, log_dir)` (more work and checks,
    giving more fields to emit).  Gates: it ran on the card, wrote
    `files`, and launched K1 = 9 + 18 a step over its eval steps and K2 /
    K3 = iters x the agent's per-step counts, K4 none."""
    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.scripts import train as cli

    fresh_phase(torch)
    t_phase = time.perf_counter()
    log = scratch / phase
    attention.reset_launch_counts()
    t0 = time.perf_counter()
    d = cli.main(argv + ["--log-dir", str(log)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    extra = {} if after is None else after(d, log)
    torch.cuda.synchronize()
    launches = attention.launch_counts()
    check(d.device.type == "cuda", f"the CLI ran on {d.device}")
    for name in files:
        check((log / name).is_file(), f"the CLI wrote no {name}")
    per_episode, per_step = eval_calls(d.cfg)
    k2, k3 = (duet_train_launches_per_step if d.cfg.agent == "duet"
              else train_launches_per_step)(d.cfg)
    iters = len(d.timings["train"])
    want = {"attention_fwd": sum(per_episode + per_step * s
                                 for s in d.eval_step_counts),
            "attention_dropout_fwd": iters * k2,
            "attention_dropout_bwd": iters * k3, "attention_bwd": 0}
    check(iters == 2 and launches == want,
          f"{phase} launches {launches}, expected {want}")
    emit({"phase": phase, "argv": " ".join(argv),
          "config": f"{d.cfg.agent}_r2r_config", "dataset": d.cfg.dataset,
          "seconds": seconds,
          "phase_s": time.perf_counter() - t_phase,
          "eval_steps": d.eval_step_counts, "expected": want,
          "interval_s": [t["seconds"] for t in d.timings["train"]],
          "validate_s": [t["seconds"] for t in d.timings["validate"]],
          "checkpoint_saves": d.ckpt.events,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, **extra})
    del d
    torch.cuda.empty_cache()
    return launches


def duet_details(d, log: Path) -> dict:
    """After the DUET CLI: the driver's validation with its outputs writes
    `detail_val_unseen.json`, one entry per item whose stop table covers
    the item's start and end, only nodes of its path, probabilities in
    [0, 1]."""
    check(d.cfg.train.expl_sample and d.cfg.train.detailed_output,
          "the flags did not reach the config")
    val = next(s for s in d.val_splits if s.name == "val_unseen")
    d.validate(val, write_outputs=True)
    preds = json.loads((log / "detail_val_unseen.json").read_text())
    check(len(preds) == val.episodes.scan.shape[0], "detail_val_unseen.json "
          f"holds {len(preds)} items")
    for p in preds:
        vps = [vp for vp, *_ in p["trajectory"]]
        check({vps[0], vps[-1]} <= p["details"].keys() <= set(vps)
              and all(0.0 <= v["stop_prob"] <= 1.0
                      for v in p["details"].values()),
              f"{p['instr_id']}: details {p['details']}")
    return {"detail_items": len(preds)}


# ------------------------------------------------- the deferred branches
# (name, config part, overrides, steps) of the HAMT and DUET train phases:
# each runs one warm-up step and times the rest.  The first entry is the
# released recipe, timed in the same phase as the variants
HAMT_VARIANTS = (
    ("released", "train", {}, 3),
    ("fused_sample_rollout", "train", {"fused_sample_rollout": True}, 3),
    ("aux_infonce", "model", {"aux_loss_type": "infonce"}, 3),
    ("aux_margin", "model", {"aux_loss_type": "margin"}, 3),
    ("imagine_encoder", "model", {"bypass_imag_encoder": False}, 3),
    # the critic's optimizer is the plain one: Lookahead syncs at step 6
    ("optim_rangerlars", "train", {"optim": "rangerlars"}, 6),
)
DUET_VARIANTS = (
    ("released", "train", {}, 3),
    ("rl", "train", {"train_alg": "rl", "gamma": 0.9}, 3),
    ("expert_ndtw", "train", {"expert_policy": "ndtw"}, 3),
    ("expl_sample", "train", {"expl_sample": True}, 3),
    ("act_visited_nodes", "train", {"act_visited_nodes": True}, 3),
)
DUET_EVAL_BATCH = 64


def stage1_split(label, model, before) -> tuple[list, list]:
    """Parameters that moved and that stayed bitwise; in stage 1 only the
    aux groups may move and all of them must."""
    moved, still = [], []
    for name, v in model.state_dict().items():
        (still if v.equal(before[name]) else moved).append(name)
    check(all(label(n) == "rest" for n in still)
          and all(label(n) != "rest" for n in moved),
          f"stage 1: moved {[n for n in moved if label(n) == 'rest'][:5]}, "
          f"still {[n for n in still if label(n) != 'rest'][:5]}")
    return moved, still


def plain_split(model, before) -> tuple[list, list]:
    """Parameters that moved and that stayed bitwise under a plain
    optimizer (no warm-up stages): those with a gradient move, the others
    (a branch the configuration never runs) stay."""
    moved, still = [], []
    for name, p in model.named_parameters():
        (still if p.equal(before[name]) else moved).append(name)
        check((p.grad is None) == (name in still),
              f"{name}: gradient {p.grad is not None}, moved "
              f"{name in moved}")
    return moved, still


def variant_steps(torch, make_trainer, ep, steps, want, k1_k4=(0, 0),
                  split=None):
    """Build a trainer on the card, run `steps` train steps (the first a
    warm-up) and gate each: finite metrics, grad_norm > 0, K2 / K3 launches
    = `want` and K1 / K4 = `k1_k4` (the ViT's, under e2e_imagination),
    stage-1 semantics (`plain_split` where the recipe has no warm-up; or
    `split(model, before)`), the critic moved (when there is one).  Returns
    (trainer, record)."""
    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.train.optim import label_hamt_param

    fresh_phase(torch)
    t0 = time.perf_counter()
    trainer = make_trainer()
    model0 = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    critic0 = (None if trainer.critic is None else
               {k: v.clone() for k, v in trainer.critic.state_dict().items()})
    step = (trainer.make_train_step("sample") if trainer.cfg.agent == "hamt"
            else trainer.make_train_step())
    step(ep, ep)  # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    times, metrics, counts = [], [], []
    for _ in range(steps - 1):
        # the counted run of one step: every count to 0 just before
        attention.reset_launch_counts()
        t = time.perf_counter()
        m = step(ep, ep)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        counts.append(attention.launch_counts())
        metrics.append({k: float(v) for k, v in m.items()})
    for m in metrics:
        check(all(math.isfinite(v) for v in m.values()), f"metrics {m}")
        check(m["grad_norm"] > 0, f"grad_norm {m['grad_norm']}")
    k2, k3 = want
    expected = {"attention_fwd": k1_k4[0], "attention_dropout_fwd": k2,
                "attention_dropout_bwd": k3, "attention_bwd": k1_k4[1]}
    for c in counts:
        check(c == expected, f"launches per step {c}, expected {expected}")
    m = trainer.cfg.model
    moved, still = (split(trainer.model, model0) if split is not None
                    else stage1_split(label_hamt_param, trainer.model, model0)
                    if m.imagine_enc_pano and m.use_cosine_aux_loss
                    else plain_split(trainer.model, model0))
    if critic0 is not None:
        check(all(not v.equal(critic0[k])
                  for k, v in trainer.critic.state_dict().items()),
              "the critic did not move")
    return trainer, {
        "setup_s": setup_s, "step_ms": statistics.median(times),
        "step_ms_all": times, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "metrics": metrics[-1], "launches_per_step": counts[-1],
        "expected_per_step": expected,
        "params_moved": len(moved), "params_unchanged": len(still)}


def most_launches(runs: dict, key: str) -> dict:
    """Per kernel, the most launches of any run of a phase."""
    return {k: max(r[key][k] for r in runs.values())
            for k in next(iter(runs.values()))[key]}


RL_KEYS = ("loss", "grad_norm", "ml_loss", "rl_loss", "aux_loss", "entropy")


def hamt_train_variants_phase(torch, cfg, world):
    """The HAMT training branches beyond the released recipe, each at the
    released config with one change (HAMT_VARIANTS), full width, bf16,
    every dropout on, batch 8 (+ 8 in the fused rollout); then one f32
    fused step card vs CPU with the same draws, at batch 1 (+ 1)."""
    from vln_imagine_tpu_torch.config import _replace
    from vln_imagine_tpu_torch.eval.trace import bench_episodes
    from vln_imagine_tpu_torch.train import rollout_hamt as RH
    from vln_imagine_tpu_torch.train.trainer import HamtTrainer

    fresh_phase(torch)
    t_phase = time.perf_counter()
    ep = bench_episodes(world, cfg, TRAIN_BATCH).to("cuda")
    runs = {}
    for name, part, over, steps in HAMT_VARIANTS:
        vcfg = _replace(cfg, part, **over)
        trainer, rec = variant_steps(
            torch, lambda: HamtTrainer(vcfg, world, device="cuda"), ep, steps,
            train_launches_per_step(vcfg))
        if name == "optim_rangerlars":
            # variant4 keeps the navigator's Ralamb without Lookahead; the
            # critic's plain optimizer synced at its sixth step, which left
            # each critic weight at its (new) slow weight
            c_opt = trainer.critic_optimizer
            check(trainer.optimizer.slow is None
                  and c_opt.lookahead_count == steps
                  and all(torch.allclose(w, p, rtol=1e-6, atol=1e-6)
                          for w, p in zip(c_opt.slow, c_opt.params())),
                  "rangerlars: no Lookahead sync of the critic at step "
                  f"{steps}")
            rec["critic_lookahead_count"] = c_opt.lookahead_count
        runs[name] = rec
        del trainer
        torch.cuda.empty_cache()
    emit({"phase": "hamt_train_variants", "config": "hamt_r2r_config",
          "compute_dtype": cfg.model.compute_dtype, "batch": TRAIN_BATCH,
          "baseline": "the train phase (released recipe)", "runs": runs,
          "phase_s": time.perf_counter() - t_phase})

    pcfg = cfg_f32(cfg, fused_sample_rollout=True)
    f32_parity(torch, "hamt_fused_f32_parity",
               lambda dev: (HamtTrainer(pcfg, world, device=dev),
                            bench_episodes(world, pcfg, 1)),
               lambda tr: tr.make_train_step("sample"), RL_KEYS,
               cfg.train.lr, draws=RH, batch=1, fused_sample_rollout=True)
    return most_launches(runs, "launches_per_step")


def duet_train_variants_phase(torch, cfg, world):
    """DUET's training branches beyond DAgger with the SPL expert, each at
    the released config with one change (DUET_VARIANTS), full width, bf16,
    every dropout on, batch 8; then one f32 'rl' step card vs CPU with the
    same draws, at batch 2."""
    from vln_imagine_tpu_torch.config import _replace
    from vln_imagine_tpu_torch.eval.trace import bench_episodes
    from vln_imagine_tpu_torch.train import rollout_duet as RD
    from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

    fresh_phase(torch)
    t_phase = time.perf_counter()
    ep = bench_episodes(world, cfg, TRAIN_BATCH).to("cuda")
    runs = {}
    for name, part, over, steps in DUET_VARIANTS:
        vcfg = _replace(cfg, part, **over)
        trainer, rec = variant_steps(
            torch, lambda: DuetTrainer(vcfg, world, device="cuda"), ep, steps,
            duet_train_launches_per_step(vcfg))
        check((trainer.critic is not None) == (name == "rl"),
              f"{name}: a critic only under train_alg 'rl'")
        runs[name] = rec
        del trainer
        torch.cuda.empty_cache()
    emit({"phase": "duet_train_variants", "config": "duet_r2r_config",
          "compute_dtype": cfg.model.compute_dtype, "batch": TRAIN_BATCH,
          "baseline": "the duet_train phase (DAgger, SPL expert)",
          "runs": runs, "phase_s": time.perf_counter() - t_phase})

    pcfg = cfg_f32(cfg, train_alg="rl", gamma=0.9)
    f32_parity(torch, "duet_rl_f32_parity",
               lambda dev: (DuetTrainer(pcfg, world, device=dev),
                            bench_episodes(world, pcfg, 2)),
               lambda tr: tr.make_train_step(), RL_KEYS, cfg.train.lr,
               draws=RD, batch=2, train_alg="rl")
    return most_launches(runs, "launches_per_step")


def check_stop_tables(paths, lens, table) -> int:
    """Each item's stop table holds the nodes it stood at: its start and end
    among them, and only nodes of its path.  Returns the table entries."""
    nodes, _, valid = (x.cpu().numpy() for x in table)
    total = 0
    for b in range(len(lens)):
        path = paths[b, :int(lens[b])].tolist()
        mine = set(nodes[b][valid[b]].tolist())
        check({path[0], path[-1]} <= mine <= set(path),
              f"item {b}: stop table {sorted(mine)} against path {path}")
        total += len(mine)
    return total


def duet_eval_variants_phase(torch, cfg, world):
    """Greedy eval under `fusion="local"` and with `detailed_output` (the
    final stop table) at the released config, full width, bf16, batch 64:
    valid walks, K1 launches 9 + 18 a step, episodes/s, and each item's
    stop table."""
    import numpy as np

    from vln_imagine_tpu_torch.config import _replace
    from vln_imagine_tpu_torch.eval.trace import bench_episodes
    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.train.rollout_duet import path_buffer_len
    from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

    fresh_phase(torch)
    per_episode, per_step = duet_calls(cfg)
    ep_np = bench_episodes(world, cfg, DUET_EVAL_BATCH)
    ep = ep_np.to("cuda")
    runs = {}
    for name, vcfg, detailed in (
            ("fusion_local", _replace(cfg, "model", fusion="local"), False),
            ("detailed_output", _replace(cfg, "train", detailed_output=True),
             True)):
        trainer = DuetTrainer(vcfg, world, device="cuda")
        eval_step = trainer.make_eval_step(detailed=detailed)
        eval_step(ep)  # warm-up
        attention.reset_launch_counts()
        out = eval_step(ep)
        torch.cuda.synchronize()
        launches = attention.launch_counts()
        steps = eval_step.steps
        nodes, lens = out[0].cpu().numpy(), out[1].cpu().numpy()
        want = per_episode + per_step * steps
        check(launches == {"attention_fwd": want, "attention_dropout_fwd": 0,
                           "attention_dropout_bwd": 0, "attention_bwd": 0},
              f"{name}: launches {launches} for {steps} steps, expected "
              f"K1 {want}")
        jumps = check_walks(world, ep_np, nodes, lens, path_buffer_len(vcfg),
                            jumps_allowed=True)
        entries = (check_stop_tables(nodes, lens, out[2]) if detailed
                   else None)
        times = []
        for _ in range(3):
            t = time.perf_counter()
            again = eval_step(ep)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            check(np.array_equal(again[0].cpu().numpy(), nodes),
                  f"{name}: greedy paths differ between runs")
        dt = statistics.median(times)
        runs[name] = {"steps": steps, "attention_launches": launches,
                      "episodes_per_s": DUET_EVAL_BATCH / dt,
                      "episode_batch_ms": dt * 1e3,
                      "episode_batch_ms_all": [x * 1e3 for x in times],
                      "path_len_max": int(lens.max()),
                      "non_edge_moves": jumps, "stop_table_entries": entries}
        del trainer
    emit({"phase": "duet_eval_variants", "config": "duet_r2r_config",
          "compute_dtype": cfg.model.compute_dtype, "batch": DUET_EVAL_BATCH,
          "baseline": "the duet_eval phase", "runs": runs})
    return most_launches(runs, "attention_launches")


# -------------------------------------------------------- task variants
# (name, preset, its arguments, objects a node, eval only): each variant at
# its preset, full width, bf16, on the bench world (with `max_objects`
# objects of 768 features a node where the task grounds objects)
VARIANT_PRESETS = (
    ("reverie_duet", "reverie_config", ("duet",), 20, False),
    ("soon_duet", "soon_config", (), 100, False),
    ("reverie_hamt", "reverie_config", ("hamt",), 20, False),
    ("r2r_back_hamt", "hamt_r2r_config", (), 0, False),
    ("cvdn_hamt", "cvdn_config", (), 0, False),
    ("rxr_hamt", "rxr_config", (), 0, False),
    ("r4r_duet", "r4r_config", ("duet",), 0, True),
    ("r4r_hamt", "r4r_config", ("hamt",), 0, True),
)
VARIANT_TRAIN_STEPS = 2  # one warm-up and one timed


def variant_cfg(preset: str, args: tuple, name: str):
    from vln_imagine_tpu_torch import config as C

    cfg = getattr(C, preset)(*args)
    return cfg.replace(dataset="r2r_back") if name == "r2r_back_hamt" else cfg


def variant_world(cfg, max_objects: int):
    """bench_world's world (the same draws), with `max_objects` objects of
    768 features a node after them."""
    from vln_imagine_tpu_torch.envx import synthetic_world

    return synthetic_world(num_scans=2, num_nodes=96,
                           max_candidates=cfg.env.max_candidates, views=36,
                           feat_dim=cfg.model.image_feat_size, seed=0,
                           max_objects=max_objects,
                           obj_feat_dim=cfg.model.obj_feat_size or None)


def out_and_back(ep):
    """r2r_back episodes: the gt path out and back (cut to the buffer),
    the midstop its far end."""
    import numpy as np

    gt_path, gt_len = np.asarray(ep.gt_path), np.asarray(ep.gt_len)
    P = gt_path.shape[1]
    paths, lens = [], []
    for b in range(ep.batch):
        fwd = gt_path[b, :gt_len[b]].tolist()
        back = (fwd + fwd[-2::-1])[:P]
        lens.append(len(back))
        paths.append(back + [back[-1]] * (P - len(back)))
    return ep.replace(gt_path=np.asarray(paths, np.int32),
                      gt_len=np.asarray(lens, np.int32),
                      midstop=gt_path[np.arange(ep.batch), gt_len - 1])


def variant_episodes(world, cfg, batch: int):
    from vln_imagine_tpu_torch.eval.trace import bench_episodes

    ep = bench_episodes(world, cfg, batch)
    return out_and_back(ep) if cfg.dataset == "r2r_back" else ep


def check_grounding(world, ep, nodes, lens, pred, T, agent) -> int:
    """Each predicted object is -1 or one that the node the item grounded
    at shows: HAMT grounds where it stops, or at step T-1 at the node it
    then leaves; DUET at the node it ends on, after the backtrack, and a
    node without objects yields the id in its first slot (the argmax of
    all-masked logits).  Returns the items that grounded an object."""
    import numpy as np

    ids, valid = np.asarray(world.obj_ids), np.asarray(world.obj_valid)
    scan, grounded = np.asarray(ep.scan), 0
    for b in range(len(lens)):
        n = int(lens[b])
        node = nodes[b, min(n - 1, T - 1) if agent == "hamt" else n - 1]
        shown = ids[scan[b], node][valid[scan[b], node]].tolist()
        ok = pred[b] == -1 or pred[b] in shown or (
            agent == "duet" and not shown and pred[b] == ids[scan[b], node, 0])
        check(ok, f"item {b}: object {pred[b]} is not at node {node} "
              f"({shown})")
        grounded += int(pred[b] != -1)
    return grounded


def check_midstops(nodes, lens, mids) -> int:
    """Each declared midstop is -1 or a node of the item's path; returns
    the items that declared one."""
    for b in range(len(lens)):
        check(mids[b] == -1 or mids[b] in nodes[b, :int(lens[b])].tolist(),
              f"item {b}: midstop {mids[b]} off its path")
    return int((mids >= 0).sum())


def variant_eval(torch, trainer, world, ep_np) -> dict:
    """Greedy eval at batch `ep_np.batch`: the counted run (valid walks, K1
    9 + 18 a step or the variant's own count, no other kernel, the
    grounded objects or the midstops), then two timed runs."""
    import numpy as np

    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.train.rollout_duet import path_buffer_len

    cfg = trainer.cfg
    per_episode, per_step = eval_calls(cfg)
    eval_step = trainer.make_eval_step()
    ep = ep_np.to("cuda")
    eval_step(ep)  # warm-up
    torch.cuda.synchronize()
    attention.reset_launch_counts()
    out = eval_step(ep)
    torch.cuda.synchronize()
    launches = attention.launch_counts()
    steps = eval_step.steps
    nodes, lens = out[0].cpu().numpy(), out[1].cpu().numpy()
    want = per_episode + per_step * steps
    check(launches == {"attention_fwd": want, "attention_dropout_fwd": 0,
                       "attention_dropout_bwd": 0, "attention_bwd": 0},
          f"{cfg.dataset} eval: launches {launches} for {steps} steps, "
          f"expected K1 {want}")
    duet = cfg.agent == "duet"
    T = cfg.env.max_action_len
    jumps = check_walks(world, ep_np, nodes, lens,
                        path_buffer_len(cfg) if duet else T + 1,
                        jumps_allowed=duet)
    rec = {"steps": steps, "attention_launches": launches,
           "path_len_max": int(lens.max()), "non_edge_moves": jumps}
    if world.obj_feat is not None:
        rec["items_grounded"] = check_grounding(
            world, ep_np, nodes, lens, out[2].cpu().numpy(), T, cfg.agent)
    if cfg.dataset == "r2r_back":
        rec["midstops_declared"] = check_midstops(nodes, lens,
                                                  out[2].cpu().numpy())
    times = []
    for _ in range(2):
        t = time.perf_counter()
        again = eval_step(ep)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        check(np.array_equal(again[0].cpu().numpy(), nodes),
              f"{cfg.dataset}: greedy paths differ between runs")
    dt = statistics.median(times)
    rec.update(episodes_per_s=ep.batch / dt, episode_batch_ms=dt * 1e3,
               episode_batch_ms_all=[x * 1e3 for x in times])
    return rec


def grounding_loss(trainer, ep) -> float:
    """The grounding CE of one teacher-forced rollout, dropout off."""
    from vln_imagine_tpu_torch.train.rollout_duet import rollout_duet
    from vln_imagine_tpu_torch.train.rollout_hamt import rollout_hamt

    rollout = rollout_hamt if trainer.cfg.agent == "hamt" else rollout_duet
    return float(rollout(trainer.model, trainer.tables, ep, trainer.cfg,
                         feedback="teacher", train_ml=1.0).og_loss.detach())


def variants_phase(torch):
    """Every task variant at its preset (VARIANT_PRESETS), full width, bf16:
    greedy eval at batch 64 (`variant_eval`), and but for R4R's presets,
    which change only capacities, the train step of the preset's recipe
    at batch 8 with every dropout on (`variant_steps`: one warm-up and two
    timed steps; K2 / K3 per step from the launch formulas, stage-1
    semantics, or for NavRef's plain optimizer every parameter that got a
    gradient moved and no other), and where objects are supervised a
    positive grounding loss of a teacher rollout.  Returns each variant's
    launches (its eval run and one train step)."""
    fresh_phase(torch)
    t_phase = time.perf_counter()
    runs, path_launches = {}, {}
    for name, preset, args, n_obj, eval_only in VARIANT_PRESETS:
        cfg = variant_cfg(preset, args, name)
        world, _ = variant_world(cfg, n_obj)
        trainer = make_variant_trainer(cfg, world)
        rec = {"dataset": cfg.dataset, "agent": cfg.agent,
               "preset": f"{preset}({', '.join(map(repr, args))})",
               "max_objects": n_obj, "vocab_size": cfg.model.vocab_size,
               "max_instr_len": cfg.env.max_instr_len,
               "max_action_len": cfg.env.max_action_len,
               "eval": variant_eval(torch, trainer, world,
                                    variant_episodes(world, cfg, 64))}
        launches = dict(rec["eval"]["attention_launches"])
        if not eval_only:
            ep = variant_episodes(world, cfg, TRAIN_BATCH).to("cuda")
            want = (train_launches_per_step(cfg) if cfg.agent == "hamt"
                    else duet_train_launches_per_step(cfg))
            trainer, rec["train"] = variant_steps(
                torch, lambda: trainer, ep, VARIANT_TRAIN_STEPS, want)
            for k, v in rec["train"]["launches_per_step"].items():
                launches[k] += v
            if n_obj:
                og = grounding_loss(trainer, ep)
                check(math.isfinite(og) and og > 0,
                      f"{name}: grounding loss {og}")
                rec["train"]["og_loss"] = og
        rec["params"] = sum(p.numel() for p in trainer.model.parameters())
        runs[name] = rec
        path_launches[name] = launches
        del trainer, world
    emit({"phase": "variants", "compute_dtype": "bfloat16",
          "eval_batch": 64, "train_batch": TRAIN_BATCH, "runs": runs,
          "phase_s": time.perf_counter() - t_phase})
    return path_launches


def make_variant_trainer(cfg, world, dev="cuda"):
    from vln_imagine_tpu_torch.train.trainer import HamtTrainer
    from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

    return (HamtTrainer if cfg.agent == "hamt" else DuetTrainer)(
        cfg, world, device=dev)


def variants_f32_parity_phase(torch):
    """Two f32 steps card vs CPU (`f32_parity`), every dropout off, at batch
    2: NavRef's 'sample' step (IL + A2C, with the grounding CE) with the
    same draws, and REVERIE-DUET's 'imitation' step, objects on both."""
    from vln_imagine_tpu_torch.train import rollout_hamt as RH

    launches = {}
    for name, preset, args, alg in (
            ("reverie_hamt", "reverie_config", ("hamt",), "sample"),
            ("reverie_duet", "reverie_config", ("duet",), "imitation")):
        cfg = variant_cfg(preset, args, name)
        pcfg = cfg_f32(cfg, **({"train_alg": alg} if alg == "imitation"
                               else {}))
        world, _ = variant_world(pcfg, 20)
        launches[f"{name}_f32_parity"] = f32_parity(
            torch, f"{name}_f32_parity",
            lambda dev: (make_variant_trainer(pcfg, world, dev),
                         variant_episodes(world, pcfg, 2)),
            lambda tr: (tr.make_train_step("sample") if alg == "sample"
                        else tr.make_train_step()),
            RL_KEYS if alg == "sample" else ("loss", "grad_norm", "ml_loss"),
            cfg.train.lr, draws=RH if alg == "sample" else None, batch=2,
            train_alg=alg, max_objects=20)
    return launches


class StandInObjectStore:
    """What `ObjectFeatureDB` reads from a REVERIE HDF5 store, served from
    a world's object arrays, for a machine without h5py:
    `load_feature(scan, viewpoint)` -> the viewpoint's object features and
    attrs `directions`, `sizes` and byte `obj_ids`."""

    def __init__(self, world, graphs):
        import numpy as np

        self.rows = {}
        for s, g in enumerate(graphs):
            for n, vp in enumerate(g.node_ids):
                k = int(np.asarray(world.obj_valid)[s, n].sum())
                pos = np.asarray(world.obj_pos)[s, n, :k]
                self.rows[(g.scan_id, vp)] = (
                    np.asarray(world.obj_feat)[s, n, :k], {
                        "directions": np.asarray(world.obj_ang)[s, n, :k],
                        "sizes": np.stack([(pos[:, 2] - pos[:, 0]) * 640,
                                           (pos[:, 3] - pos[:, 1]) * 480], -1),
                        "obj_ids": np.asarray([str(i).encode() for i in
                                               np.asarray(world.obj_ids)
                                               [s, n, :k]])})

    def load_feature(self, scan, viewpoint, max_objects=None):
        fts, attrs = self.rows[(scan, viewpoint)]
        return fts[:max_objects], {k: v[:max_objects]
                                   for k, v in attrs.items()}


def variant_driver_phase(torch):
    """`FinetuneDriver.validate` of REVERIE-DUET at its preset, full width,
    bf16, on 100 items in batches of 64: the object tables built by
    `build_object_tables` from a stand-in store of the world's objects,
    the submission written with the graphs.  Gates: the tables equal the
    world's objects, K1 = 9 + 18 a step over the eval batches (the loop's
    own step counts) and no other kernel, finite RGS / RGSPL / SR / SPL,
    one `predObjId` an item."""
    import numpy as np

    from vln_imagine_tpu_torch.data.features import build_object_tables
    from vln_imagine_tpu_torch.driver import FinetuneDriver, SplitData
    from vln_imagine_tpu_torch.ops import attention

    fresh_phase(torch)
    t_phase = time.perf_counter()
    cfg = variant_cfg("reverie_config", ("duet",), "reverie_duet")
    world, graphs = variant_world(cfg, 20)
    o_feat, o_ang, o_valid, o_ids, o_pos, _ = build_object_tables(
        StandInObjectStore(world, graphs), graphs, 20,
        cfg.model.obj_feat_size, max_nodes=world.node_xyz.shape[1])
    for a, b in ((o_feat, world.obj_feat), (o_ang, world.obj_ang),
                 (o_valid, world.obj_valid)):
        check(np.array_equal(a[o_valid], np.asarray(b)[o_valid])
              and np.array_equal(o_valid, world.obj_valid),
              "the object tables differ from the world's objects")
    check(np.array_equal(o_ids[o_valid], world.obj_ids[o_valid]),
          "the object ids differ from the world's")
    tables = world.replace(obj_feat=o_feat, obj_ang=o_ang, obj_valid=o_valid,
                           obj_ids=o_ids, obj_pos=o_pos)
    ep = variant_episodes(tables, cfg, DRIVER_VAL_PATHS)
    val = SplitData("val_unseen", ep,
                    [f"{b}_{ep.gt_obj_id[b]}_0" for b in range(ep.batch)])
    with scratch_dir() as tmp:
        d = FinetuneDriver(cfg, tables, val, [val], tmp, graphs=graphs,
                           device="cuda")
        d.setup()
        d.validate(val)  # warm-up
        attention.reset_launch_counts()
        d.eval_step_counts.clear()
        t0 = time.perf_counter()
        score = d.validate(val, write_outputs=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = attention.launch_counts()
        sub = json.loads((Path(tmp) / "submit_val_unseen.json").read_text())
    per_episode, per_step = eval_calls(cfg)
    want = {"attention_fwd": sum(per_episode + per_step * s
                                 for s in d.eval_step_counts),
            "attention_dropout_fwd": 0, "attention_dropout_bwd": 0,
            "attention_bwd": 0}
    check(launches == want, f"reverie validate launches {launches}, "
          f"expected {want}")
    check({"rgs", "rgspl", "sr", "spl"} <= score.keys()
          and all(math.isfinite(v) for v in score.values()),
          f"reverie validate metrics {score}")
    check(len(sub) == ep.batch and all(isinstance(p["predObjId"], str)
                                       for p in sub),
          "the submission lacks a predObjId an item")
    emit({"phase": "variant_driver", "config": "reverie_config('duet')",
          "items": ep.batch, "eval_batch": cfg.train.eval_batch_size,
          "eval_steps": d.eval_step_counts, "metrics": score,
          "validate_s": seconds, "episodes_per_s": ep.batch / seconds,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "phase_s": time.perf_counter() - t_phase})
    del d
    return launches


def r2r_back_cli(torch, scratch: Path):
    """The train CLI with `--dataset r2r_back` on files written as
    `write_run_files` does (the ReturnBack layout, a midstop an item), the
    view features served by an `InMemoryFeaturesDB` in the HDF5 reader's
    place (for a machine without h5py); `cli_phase` gates it."""
    import vln_imagine_tpu_torch.data.features as F
    from vln_imagine_tpu_torch.config import hamt_r2r_config
    from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world

    cfg = hamt_r2r_config()
    world, graphs = synthetic_world(
        num_scans=2, num_nodes=96, max_candidates=cfg.env.max_candidates,
        views=36, feat_dim=cfg.model.image_feat_size, seed=0)
    ep = synthetic_episodes(
        world, batch=DRIVER_TRAIN_PATHS + DRIVER_VAL_PATHS,
        max_gt_path_len=cfg.env.max_gt_path_len,
        max_instr_len=cfg.env.max_instr_len,
        max_imaginations=cfg.model.max_imagination_len,
        vocab_size=cfg.model.vocab_size, feat_dim=cfg.model.hidden_size,
        seed=1)
    root = scratch / "files"
    write_run_files(cfg, graphs, out_and_back(ep), root, dataset="r2r_back")
    views = {f"{g.scan_id}_{vp}": world.feat[s, i]
             for s, g in enumerate(graphs) for i, vp in enumerate(g.node_ids)}
    orig = F.ImageFeaturesDB
    F.ImageFeaturesDB = lambda path, dim: F.InMemoryFeaturesDB(views)
    try:
        return cli_phase(
            torch, scratch, "train_cli_r2r_back",
            ["--dataset", "r2r_back", "--connectivity-dir",
             str(root / "connectivity"), "--anno-dir",
             str(root / "annotations"), "--img-features", "in-memory",
             "--generated-flag-file", str(root / "generated_flags.json"),
             "--sub-instr-file", str(root / "sub_instr.json"),
             "--splits", "train", "val_unseen", "--iters", "2",
             "--log-every", "1"], after=r2r_back_scores)
    finally:
        F.ImageFeaturesDB = orig


def r2r_back_scores(d, log: Path) -> dict:
    """After the r2r_back CLI: its episodes carry midstops and its
    validation scored them (individual metrics per item)."""
    val = next(s for s in d.val_splits if s.name == "val_unseen")
    check(d.cfg.dataset == "r2r_back"
          and (val.episodes.midstop >= 0).all(),
          "the r2r_back episodes carry no midstop")
    score = d.validate(val)
    check(all(math.isfinite(v) for v in score.values()),
          f"r2r_back validate metrics {score}")
    return {"val_metrics": score}


# ------------------------------------------------ the ViT and pre-training
VIT_BATCH = 64       # images a FeatureExtractor batch (and K1's ViT case)
VIT_BATCHES = 4      # batches timed in vit_extract
VIT_TOL = 1e-4       # the f32 class token, card vs CPU
PRETRAIN_BATCH = 16  # the released pre-training batch
PRETRAIN_PROBS = 1000  # image_prob_size of the released model config
E2E_PRETRAIN_BATCH = 2


def vit_calls(cfg) -> int:
    """Attention calls of one pass of the navigator's ViT (e2e_imagination;
    the ViT has no dropout: K1 forward, K4 backward when it trains)."""
    m = cfg.model
    return (m.e2e_vit_layers if m.imagine_enc_pano
            and m.e2e_imagination != "off" else 0)


def pretrain_calls(cfg, task: str) -> tuple[int, int]:
    """Attention calls of one pre-training task's step, forward (K2 in
    training, K1 in validation) and backward: the language stack, the
    history pano encoder over every step at once (three times for ITM: the
    positive and its two order-shuffled negatives) and the cross-modal
    layers (4 each) over text x [history; observation].  The backward
    skips the last cross-modal layer's branch that no loss reads (its
    cross- and self-attention): the visual one for mlm and sar (the text's
    [CLS]), the language one for sprel and mrc; sap and itm read both."""
    m = cfg.model
    hist = 3 if task == "itm" else 1
    fwd = m.num_l_layers + hist * m.num_pano_layers + 4 * m.num_x_layers
    return fwd, fwd - (0 if task in ("sap", "itm") else 2)


def e2e_episodes(world, cfg, batch: int, seed: int = 1, images=True):
    """bench_episodes (another `seed`), with raw imagination images at the
    ViT's size unless `images` is false."""
    from vln_imagine_tpu_torch.envx import synthetic_episodes

    return synthetic_episodes(
        world, batch=batch, max_gt_path_len=cfg.env.max_gt_path_len,
        max_instr_len=cfg.env.max_instr_len,
        max_imaginations=cfg.model.max_imagination_len,
        vocab_size=cfg.model.vocab_size, feat_dim=cfg.model.hidden_size,
        seed=seed, imagine_image_size=(cfg.model.e2e_vit_image_size
                                       if images else None))


def vit_extract_phase(torch):
    """`FeatureExtractor` at ViT-B/16 224, bf16, batches of 64 from host
    arrays: 12 K1 a batch, images/s, peak memory; the f32 class token of 4
    images, card vs CPU, within VIT_TOL."""
    import copy

    import numpy as np

    from vln_imagine_tpu_torch.models.vit import (
        FeatureExtractor,
        ViTConfig,
        VisionTransformer,
    )
    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.train.trainer import init_params

    fresh_phase(torch)
    cfg = ViTConfig()
    t0 = time.perf_counter()
    ext = FeatureExtractor.random_init(torch.Generator().manual_seed(0), cfg,
                                       batch_size=VIT_BATCH, device="cuda")
    images = np.random.default_rng(0).standard_normal(
        (VIT_BATCH * VIT_BATCHES, 224, 224, 3), dtype=np.float32)
    ext.extract(images[:VIT_BATCH])  # warm-up
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    attention.reset_launch_counts()
    t = time.perf_counter()
    feats = ext.extract(images)  # returns host arrays: the device is done
    host_s = time.perf_counter() - t
    launches = attention.launch_counts()
    want = {"attention_fwd": cfg.num_layers * VIT_BATCHES,
            "attention_dropout_fwd": 0, "attention_dropout_bwd": 0,
            "attention_bwd": 0}
    check(launches == want, f"vit_extract launches {launches}, want {want}")
    check(feats.shape == (len(images), 768) and np.isfinite(feats).all(),
          f"features {feats.shape}")
    x = torch.as_tensor(images[:VIT_BATCH], device="cuda")
    times = []
    with torch.no_grad():
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ext.model(x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    del ext, x
    # f32, card vs CPU, the same weights
    vit = VisionTransformer(ViTConfig(compute_dtype="float32"))
    init_params(vit, torch.Generator().manual_seed(1))
    card = FeatureExtractor(copy.deepcopy(vit), device="cuda").extract(
        images[:4])
    cpu = FeatureExtractor(vit, device="cpu").extract(images[:4])
    err = float(np.abs(card - cpu).max())
    emit({"phase": "vit_extract", "config": "ViT-B/16 224",
          "compute_dtype": cfg.compute_dtype, "batch": VIT_BATCH,
          "images": len(images), "setup_s": setup_s,
          "images_per_s": len(images) / host_s,
          "batch_device_ms": statistics.median(times),
          "batch_device_ms_all": times,
          "device_images_per_s": VIT_BATCH / statistics.median(times) * 1e3,
          "peak_mem_bytes": peak, "launches": launches,
          "f32_cls_max_abs_err": err, "tol": VIT_TOL})
    check(err <= VIT_TOL, f"f32 class token card vs CPU {err}")
    return launches


def e2e_cfg(cfg, mode: str, **train):
    """`cfg` with the ViT in the loop; 'trainable' runs with the warm-up's
    stage 1 of length 0, so that the ViT (in the "rest" group) trains from
    the first step."""
    from vln_imagine_tpu_torch.config import _replace

    cfg = _replace(cfg, "model", e2e_imagination=mode)
    if mode == "trainable":
        train = dict(warmup_stage1_iters=0, **train)
    return _replace(cfg, "train", **train) if train else cfg


def vit_split(mode):
    """The moved / unchanged split of an e2e train step: 'frozen' keeps
    stage 1 (only the aux groups move) and the ViT bitwise; 'trainable'
    moves every parameter with a gradient, the ViT's among them."""
    from vln_imagine_tpu_torch.train.optim import label_hamt_param

    def split(model, before):
        if mode == "frozen":
            moved, still = stage1_split(label_hamt_param, model, before)
        else:
            moved, still = plain_split(model, before)
        vit = [n for n in before if n.startswith("imagine_vit.")]
        check(vit and all((n in moved) == (mode == "trainable") for n in vit),
              f"{mode} ViT: moved {[n for n in vit if n in moved][:3]}, "
              f"unchanged {[n for n in vit if n in still][:3]}")
        return moved, still

    return split


def e2e_finetune_phase(torch, cfg, dcfg, world):
    """The ViT in the fine-tune loop (`e2e_imagination`) at the released
    configs, full width, bf16: the HAMT 'sample' step frozen and trainable
    and the DUET DAgger step trainable at batch 8 (20 imaginations an item:
    160 images through the ViT a rollout, two rollouts a step), then HAMT
    greedy eval at batch 64 (1,280 images).  Gates: `variant_steps`' (K1 =
    12 a rollout, K4 = 12 a rollout when trainable, K2 / K3 from the
    launch formulas; the ViT bitwise unchanged when frozen, moved when
    trainable), valid walks and K1 = 9 + 12 + 18 a step in eval."""
    import numpy as np

    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.train.trainer import HamtTrainer
    from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

    runs = {}
    for name, base, mode, cls, formula in (
            ("hamt_frozen", cfg, "frozen", HamtTrainer,
             train_launches_per_step),
            ("hamt_trainable", cfg, "trainable", HamtTrainer,
             train_launches_per_step),
            ("duet_trainable", dcfg, "trainable", DuetTrainer,
             duet_train_launches_per_step)):
        c = e2e_cfg(base, mode)
        ep = e2e_episodes(world, c, TRAIN_BATCH).to("cuda")
        vit = 2 * vit_calls(c)  # IL / teacher-forced and RL / student
        trainer, rec = variant_steps(
            torch, lambda: cls(c, world, device="cuda"), ep, 3, formula(c),
            k1_k4=(vit, vit if mode == "trainable" else 0),
            split=vit_split(mode))
        rec["vit_images_per_rollout"] = int(np.prod(
            ep.imagine_images.shape[:2]))
        runs[name] = rec
        del trainer, ep
        torch.cuda.empty_cache()

    fresh_phase(torch)
    c = e2e_cfg(cfg, "frozen")
    per_episode, per_step = eval_calls(c)
    trainer = HamtTrainer(c, world, device="cuda")
    eval_step = trainer.make_eval_step()
    ep_np = e2e_episodes(world, c, BATCHES[0])
    ep = ep_np.to("cuda")
    eval_step(ep)  # warm-up
    torch.cuda.synchronize()
    attention.reset_launch_counts()
    t = time.perf_counter()
    nodes, lens = eval_step(ep)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = attention.launch_counts()
    nodes, lens = nodes.cpu().numpy(), lens.cpu().numpy()
    check_walks(world, ep_np, nodes, lens, c.env.max_action_len + 1)
    steps = min(int(lens.max()), c.env.max_action_len)
    want = {"attention_fwd": per_episode + vit_calls(c) + per_step * steps,
            "attention_dropout_fwd": 0, "attention_dropout_bwd": 0,
            "attention_bwd": 0}
    check(launches == want, f"e2e eval launches {launches}, want {want}")
    runs["hamt_eval"] = {"batch": BATCHES[0], "steps": steps,
                         "episodes_per_s": BATCHES[0] / dt,
                         "episode_batch_ms": dt * 1e3,
                         "vit_images": int(np.prod(ep_np.imagine_images.shape[:2])),
                         "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                         "launches": launches}
    del trainer, ep
    torch.cuda.empty_cache()
    emit({"phase": "e2e_finetune", "configs": "hamt_r2r_config / "
          "duet_r2r_config + e2e_imagination", "compute_dtype":
          cfg.model.compute_dtype, "vit": "ViT-B/16 224", "runs": runs})
    return {k: max(r["launches_per_step"][k] if "launches_per_step" in r
                   else r["launches"][k] for r in runs.values())
            for k in launches}


def e2e_train_parity_phase(torch, cfg, world):
    """One HAMT teacher step with the ViT trainable, f32, batch 2 (40
    images), card vs CPU (`f32_parity`), with the ViT's first qkv
    gradient."""
    from vln_imagine_tpu_torch.train.trainer import HamtTrainer

    c = cfg_f32(e2e_cfg(cfg, "trainable"))

    def vit_grad(tr):
        return {"imagine_vit_qkv_grad":
                tr.model.imagine_vit.blocks[0].attn.qkv.weight.grad}

    return f32_parity(
        torch, "e2e_train_parity",
        lambda dev: (HamtTrainer(c, world, device=dev),
                     e2e_episodes(world, c, 2)),
        lambda tr: tr.make_train_step("teacher"),
        ("loss", "grad_norm", "ml_loss", "aux_loss"), cfg.train.lr,
        grads=vit_grad, batch=2, feedback="teacher",
        e2e_imagination="trainable")


def _grad_rel_err(torch, a, b) -> float:
    """max |g_a - g_b| over every parameter, over max |g_b|."""
    diff = max(float((x.grad.cpu() - y.grad).abs().max())
               for x, y in zip(a.parameters(), b.parameters())
               if y.grad is not None)
    scale = max(float(y.grad.abs().max()) for y in b.parameters()
                if y.grad is not None)
    return diff / max(scale, 1e-30)


def hamt_pretrain_phase(torch, cfg, world):
    """`HamtPretrainer` at hamt_r2r_config, batch 16, image_prob_size 1000,
    trajectories of the bench episodes: one step of each of the six tasks
    after a warm-up round, each with K2 / K3 = its attention calls
    (`pretrain_calls`); `validate` on a held-out split (K1 only); then each
    task's f32 loss and gradients at batch 2, dropout off, card vs CPU
    within TRAIN_TOL."""
    import copy

    from vln_imagine_tpu_torch.eval.trace import bench_episodes
    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.pretrain.data import TrajectoryBatcher
    from vln_imagine_tpu_torch.pretrain.hamt_model import (
        TASKS,
        HamtPretrainModel,
    )
    from vln_imagine_tpu_torch.pretrain.trainer import (
        TASK_ARGS,
        HamtPretrainer,
    )
    from vln_imagine_tpu_torch.train.trainer import init_params

    fresh_phase(torch)
    t0 = time.perf_counter()
    pt = HamtPretrainer(cfg, world, bench_episodes(world, cfg, 64),
                        image_prob_size=PRETRAIN_PROBS, device="cuda")
    pt.add_validation_split("val_unseen", world,
                            e2e_episodes(world, cfg, 32, seed=2,
                                         images=False), seed=1)
    state = pt.init_state()
    for task in TASKS:  # warm-up round
        state, _ = pt.train_step(state, task,
                                 pt.batcher.task_batch(task, PRETRAIN_BATCH))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    tasks = {}
    for task in TASKS:
        batch = pt.batcher.task_batch(task, PRETRAIN_BATCH)
        attention.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = pt.train_step(state, task, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        k2, k3 = pretrain_calls(cfg, task)
        want = {"attention_fwd": 0, "attention_dropout_fwd": k2,
                "attention_dropout_bwd": k3, "attention_bwd": 0}
        got = attention.launch_counts()
        check(got == want, f"pretrain {task} launches {got}, want {want}")
        check(math.isfinite(float(m["loss"])), f"pretrain {task} loss")
        tasks[task] = {"step_ms": ms, "loss": float(m["loss"]),
                       "launches": got}
    peak = torch.cuda.max_memory_allocated()
    attention.reset_launch_counts()
    t = time.perf_counter()
    val = pt.validate(state, batch_size=8, num_batches=2)
    val_s = time.perf_counter() - t
    val_launches = attention.launch_counts()
    want = {"attention_fwd": 2 * sum(pretrain_calls(cfg, t)[0]
                                     for t in TASKS),
            "attention_dropout_fwd": 0, "attention_dropout_bwd": 0,
            "attention_bwd": 0}
    check(val_launches == want, f"validate launches {val_launches}")
    check(all(math.isfinite(v["loss"]) for v in val.values()), f"val {val}")
    launches = {k: max(max(r["launches"][k] for r in tasks.values()),
                       val_launches[k]) for k in val_launches}
    del pt
    torch.cuda.empty_cache()

    # f32, dropout off, the same weights and batches on both sides
    c32 = cfg_f32(cfg)
    cpu = HamtPretrainModel(c32.model, image_prob_size=PRETRAIN_PROBS)
    init_params(cpu, torch.Generator().manual_seed(3))
    card = copy.deepcopy(cpu).cuda()
    batcher = TrajectoryBatcher(
        world, bench_episodes(world, cfg, 8),
        max_hist_len=cfg.env.max_action_len,
        angle_feat_size=cfg.model.angle_feat_size,
        image_prob_size=PRETRAIN_PROBS, vocab_size=cfg.model.vocab_size,
        seed=4)
    parity = {}
    attention.reset_launch_counts()
    for task in TASKS:
        batch = batcher.task_batch(task, 2)
        out = []
        for model, dev in ((card, "cuda"), (cpu, "cpu")):
            model.zero_grad(set_to_none=True)
            s, n, _ = getattr(model, f"forward_{task}")(
                *(torch.as_tensor(batch[k]).to(dev) for k in TASK_ARGS[task]))
            (s / max(int(n), 1)).backward()
            out.append(float(s.detach()))
        rel = abs(out[0] - out[1]) / max(abs(out[1]), 1e-30)
        grad = _grad_rel_err(torch, card, cpu)
        parity[task] = {"loss_sum_card": out[0], "loss_sum_cpu": out[1],
                        "loss_rel_err": rel, "grad_rel_err": grad}
        check(rel <= TRAIN_TOL and grad <= TRAIN_TOL,
              f"pretrain f32 {task}: loss {rel}, gradients {grad}")
    f32_launches = attention.launch_counts()
    check(f32_launches["attention_fwd"] > 0 and f32_launches["attention_bwd"]
          > 0 and f32_launches["attention_dropout_fwd"] == 0,
          f"pretrain f32 launches {f32_launches}")
    emit({"phase": "hamt_pretrain", "config": "hamt_r2r_config",
          "compute_dtype": cfg.model.compute_dtype, "batch": PRETRAIN_BATCH,
          "image_prob_size": PRETRAIN_PROBS, "setup_s": setup_s,
          "tasks": tasks, "peak_mem_bytes": peak, "validate": val,
          "validate_s": val_s, "validate_launches": val_launches,
          "f32_parity": parity, "f32_launches": f32_launches,
          "tol": TRAIN_TOL})
    return launches


class SyntheticPanoramas:
    """A raw panorama bank indexed as RawPanoramaBank ([scan, node] ->
    [V, h, w, 3], [scan, node, view] -> [h, w, 3]), made from a seed: 36
    base views drawn once, each node's a scaled and shifted copy.  The full
    bench world at 224 px would be 4.2 GB of f32 pixels."""

    def __init__(self, shape, size: int, seed: int):
        import numpy as np

        self.shape = tuple(shape) + (size, size, 3)
        rng = np.random.default_rng(seed)
        self.base = rng.standard_normal((shape[2], size, size, 3),
                                        dtype=np.float32)
        self.scale = rng.uniform(0.5, 1.5, shape[:2]).astype(np.float32)
        self.shift = rng.uniform(-0.5, 0.5, shape[:2]).astype(np.float32)

    def __getitem__(self, key):
        s, n = int(key[0]), int(key[1])
        views = self.base if len(key) == 2 else self.base[int(key[2])]
        return views * self.scale[s, n] + self.shift[s, n]


def e2e_pretrain_phase(torch, cfg, world):
    """`E2EPretrainer` at hamt_r2r_config with ViT-B/16 224 in the step,
    batch 2, max_hist_len 15: per step 1,080 history panorama views through
    the ViT with no autograd, the history views and observations with it.
    A warm-up step, then one step of each task.  Gates: per task K1 = 12 a
    ViT call (three with observations, else two), K4 = 12 a ViT call with
    autograd, K2 / K3 = the task's backbone calls; the panorama call runs
    with autograd off and returns no graph; finite losses."""
    import numpy as np

    from vln_imagine_tpu_torch.eval.trace import bench_episodes
    from vln_imagine_tpu_torch.models.vit import ViTConfig
    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.pretrain.hamt_model import TASKS
    from vln_imagine_tpu_torch.pretrain.trainer import (
        E2E_TASK_ARGS,
        E2EPretrainer,
    )

    fresh_phase(torch)
    t0 = time.perf_counter()
    S, N, V = np.asarray(world.feat).shape[:3]
    vit_cfg = ViTConfig(compute_dtype=cfg.model.compute_dtype)
    pt = E2EPretrainer(cfg, world, bench_episodes(world, cfg, 64),
                       SyntheticPanoramas((S, N, V), vit_cfg.image_size, 5),
                       vit_config=vit_cfg, image_prob_size=PRETRAIN_PROBS,
                       device="cuda")
    calls = []
    forward = pt.model.vit.forward

    def recorded(images):
        out = forward(images)
        calls.append((images.shape[0], torch.is_grad_enabled(),
                      out[0].requires_grad))
        return out

    pt.model.vit.forward = recorded
    state = pt.init_state()
    state, _ = pt.train_step(state, "mlm", pt.batcher.task_batch(
        "mlm", E2E_PRETRAIN_BATCH))  # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    tasks = {}
    T = cfg.env.max_action_len
    for task in TASKS:
        batch = pt.batcher.task_batch(task, E2E_PRETRAIN_BATCH)
        calls.clear()
        attention.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = pt.train_step(state, task, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        got = attention.launch_counts()
        obs = "ob_images" in E2E_TASK_ARGS[task]
        k2, k3 = pretrain_calls(cfg, task)
        want = {"attention_fwd": vit_cfg.num_layers * (3 if obs else 2),
                "attention_dropout_fwd": k2, "attention_dropout_bwd": k3,
                "attention_bwd": vit_cfg.num_layers * (2 if obs else 1)}
        check(got == want, f"e2e pretrain {task} launches {got}, want {want}")
        pano = E2E_PRETRAIN_BATCH * T * V
        check(calls[1] == (pano, False, False) and all(
            g and r for _, g, r in calls[:1] + calls[2:]),
            f"e2e pretrain {task} ViT calls {calls}")
        check(math.isfinite(float(m["loss"])), f"e2e pretrain {task} loss")
        tasks[task] = {"step_ms": ms, "loss": float(m["loss"]),
                       "vit_calls": [{"images": b, "autograd": g}
                                     for b, g, _ in calls],
                       "launches": got}
    peak = torch.cuda.max_memory_allocated()
    del pt.model.vit.forward
    del pt
    torch.cuda.empty_cache()
    emit({"phase": "e2e_pretrain", "config": "hamt_r2r_config + ViT-B/16 224",
          "compute_dtype": cfg.model.compute_dtype,
          "batch": E2E_PRETRAIN_BATCH, "max_hist_len": T,
          "pano_images_per_step": E2E_PRETRAIN_BATCH * T * V,
          "setup_s": setup_s, "tasks": tasks, "peak_mem_bytes": peak})
    return {k: max(r["launches"][k] for r in tasks.values())
            for k in tasks["mlm"]["launches"]}


def pretrain_cli_phase(torch, scratch: Path):
    """The pre-training CLI on the card as a user runs it, with no
    --device: `--agent hamt --synthetic --steps 4 --log-steps 2
    --valid-steps 2`, the same with `--e2e` (at 32 px and batch 2: the
    synthetic bank of its world at 224 px would be 4.2 GB), and with
    `--agent duet` (the DUET preset: mlm / mrc / sap at batch 64); each
    writes `model_step_4`.  Then the train CLI `--synthetic --iters 2
    --log-every 1 --init-from-pretrain` the HAMT feature run's snapshot
    and, `--agent duet`, the DUET run's: each must transfer leaves."""
    import contextlib
    import io
    import re

    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.scripts import pretrain as pcli
    from vln_imagine_tpu_torch.scripts import train as tcli

    fresh_phase(torch)
    base = ["--synthetic", "--steps", "4", "--log-steps", "2",
            "--valid-steps", "2"]
    runs = {}
    for name, extra in (("features", ["--agent", "hamt"]),
                        ("e2e", ["--agent", "hamt", "--e2e", "--image-size",
                                 "32", "--batch-size", "2"]),
                        ("duet", ["--agent", "duet"])):
        log = scratch / name
        attention.reset_launch_counts()
        t = time.perf_counter()
        pt, state = pcli.main(base + extra + ["--log-dir", str(log)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = attention.launch_counts()
        record = (log / "pretrain.txt").read_text()
        losses = [float(x) for x in re.findall(r"loss=([^\s,]+)", record)]
        check(pt.device.type == "cuda" and state.step == 4,
              f"pretrain CLI {name}: {pt.device}, step {state.step}")
        for f in ("model_step_2", "model_step_4", "train_state_4"):
            check((log / f).is_file(), f"pretrain CLI {name} wrote no {f}")
        check("valid @ step 4" in record and losses
              and all(math.isfinite(x) for x in losses),
              f"pretrain CLI {name} record")
        check(launches["attention_dropout_fwd"] > 0
              and launches["attention_dropout_bwd"] > 0
              and launches["attention_fwd"] > 0
              and (launches["attention_bwd"] > 0) == (name == "e2e"),
              f"pretrain CLI {name} launches {launches}")
        runs[name] = {"seconds": seconds, "launches": launches,
                      "agent": pt.cfg.agent, "tasks": pt.cfg.pretrain.tasks,
                      "batch": pt.cfg.pretrain.batch_size,
                      "hidden_size": pt.cfg.model.hidden_size,
                      "valid_losses": losses}
        del pt
        torch.cuda.empty_cache()
    check(runs["duet"]["batch"] == DUET_PRETRAIN_BATCH
          and runs["duet"]["tasks"] == DUET_PRETRAIN_TASKS,
          f"the DUET preset: {runs['duet']}")
    for name, agent, source in (("finetune", "hamt", "features"),
                                ("finetune_duet", "duet", "duet")):
        out = io.StringIO()
        attention.reset_launch_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            d = tcli.main(["--agent", agent, "--synthetic", "--iters", "2",
                           "--log-every", "1", "--init-from-pretrain",
                           str(scratch / source / "model_step_4"),
                           "--log-dir", str(scratch / name)])
        torch.cuda.synchronize()
        m = re.search(r"\((\d+) leaves transferred", out.getvalue())
        check(m is not None and int(m.group(1)) > 0
              and d.device.type == "cuda",
              f"--init-from-pretrain ({agent}): {out.getvalue()[-500:]}")
        runs[name] = {"seconds": time.perf_counter() - t,
                      "leaves_transferred": int(m.group(1)),
                      "launches": attention.launch_counts()}
        del d
        torch.cuda.empty_cache()
    emit({"phase": "pretrain_cli", "argv": " ".join(base), "runs": runs,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    return {k: max(r["launches"][k] for r in runs.values())
            for k in runs["e2e"]["launches"]}


# ------------------------------------------------------ DUET pre-training
DUET_PRETRAIN_TASKS = ("mlm", "mrc", "sap")  # r2r_pretrain.json, 1:1:1
DUET_PRETRAIN_BATCH = 64  # the released DUET pre-training batch
DUET_OG_BATCH = 8
DUET_OG_OBJECTS = 20  # REVERIE's objects a node (variants phase)


def duet_pretrain_calls(cfg, task: str) -> int:
    """Attention calls of one DUET pre-training step of `task`, forward (K2
    in training, K1 in validation) and backward alike: the language stack,
    the pano encoder over every step of every trajectory at once, and the
    cross-modal layers (a cross- and a self-attention each) in both
    branches for mlm (the language queries each, lang2visn) and sap, in the
    local branch alone for mrc and og, which do not read the global one."""
    m = cfg.model
    branches = 2 if task in ("mlm", "sap") else 1
    return m.num_l_layers + m.num_pano_layers + 2 * branches * m.num_x_layers


def duet_pretrain_cfg(cfg, tasks: tuple, batch: int):
    from vln_imagine_tpu_torch.config import _replace

    return _replace(cfg, "pretrain", tasks=tasks,
                    mix_ratio=(1,) * len(tasks), batch_size=batch)


def device_busy_ms(torch, fn):
    """One call of `fn` under torch.profiler: (its result, the device busy
    ms: the union of the traced kernels' and copies' intervals)."""
    from torch.profiler import ProfilerActivity, profile

    from vln_imagine_tpu_torch.eval.trace import _busy_us

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(device), "the profiler recorded no device activity")
    return out, _busy_us((e.time_range.start, e.time_range.end)
                         for e in device) / 1e3


def duet_pretrain_steps(torch, pt, state, batch: int):
    """One counted, timed step of each of `pt`'s tasks (its batch made on
    the host first), then one more under the profiler for the device's
    busy time.  Gates: K2 = K3 = `duet_pretrain_calls`, K1 / K4 none,
    finite losses, a count > 0."""
    from vln_imagine_tpu_torch.ops import attention

    tasks = {}
    for task in pt.cfg.pretrain.tasks:
        t = time.perf_counter()
        b = pt.batcher.task_batch(task, batch)
        host_ms = (time.perf_counter() - t) * 1e3
        attention.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = pt.train_step(state, task, b)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3
        got = attention.launch_counts()
        k = duet_pretrain_calls(pt.cfg, task)
        want = {"attention_fwd": 0, "attention_dropout_fwd": k,
                "attention_dropout_bwd": k, "attention_bwd": 0}
        check(got == want, f"duet pretrain {task} launches {got}, want {want}")
        check(math.isfinite(float(m["loss"])) and int(m["n"]) > 0,
              f"duet pretrain {task}: loss {m['loss']}, n {m['n']}")
        b = pt.batcher.task_batch(task, batch)
        (state, _), busy = device_busy_ms(
            torch, lambda: pt.train_step(state, task, b))
        tasks[task] = {
            "host_batch_ms": host_ms, "step_ms": step_ms,
            "device_busy_ms": busy,
            "host_share": host_ms / (host_ms + step_ms),
            "device_share": busy / (host_ms + step_ms),
            "batch_bytes": sum(v.nbytes for v in b.values()),
            "loss": float(m["loss"]), "n": int(m["n"]), "launches": got}
    return state, tasks


def duet_pretrain_parity(torch, cfg, world, ep, tasks, image_prob_size):
    """Each task's f32 loss and gradients at batch 2, every dropout off:
    the model on the card (K1, K4 with dBias into sprel_linear) against the
    same weights on the CPU, on the same batch, within TRAIN_TOL."""
    import copy
    import dataclasses

    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.pretrain.duet_data import (
        DuetTrajectoryBatcher,
    )
    from vln_imagine_tpu_torch.pretrain.duet_model import DuetPretrainModel
    from vln_imagine_tpu_torch.pretrain.trainer import DUET_TASK_ARGS
    from vln_imagine_tpu_torch.train.trainer import init_params

    c32 = cfg_f32(cfg)
    cpu = DuetPretrainModel(
        dataclasses.replace(c32.model, use_lang2visn_attn=True),
        image_prob_size=image_prob_size, tasks=tasks)
    init_params(cpu, torch.Generator().manual_seed(3))
    card = copy.deepcopy(cpu).cuda()
    batcher = DuetTrajectoryBatcher(
        world, ep, max_hist_len=cfg.env.max_action_len,
        max_gmap_nodes=cfg.env.max_gmap_nodes,
        angle_feat_size=cfg.model.angle_feat_size,
        image_prob_size=image_prob_size, vocab_size=cfg.model.vocab_size,
        seed=4)
    out = {}
    attention.reset_launch_counts()
    for task in tasks:
        for _ in range(50):  # og: a batch in which a target object shows
            batch = batcher.task_batch(task, 2)
            if task != "og" or (batch["obj_labels"] >= 0).any():
                break
        losses, counts = [], []
        for model, dev in ((card, "cuda"), (cpu, "cpu")):
            model.zero_grad(set_to_none=True)
            s, n, _ = getattr(model, f"forward_{task}")(
                *(torch.as_tensor(batch[k]).to(dev)
                  for k in DUET_TASK_ARGS[task]))
            (s / max(int(n), 1)).backward()
            losses.append(float(s.detach()))
            counts.append(int(n))
        rel = abs(losses[0] - losses[1]) / max(abs(losses[1]), 1e-30)
        grad = _grad_rel_err(torch, card, cpu)
        out[task] = {"loss_sum_card": losses[0], "loss_sum_cpu": losses[1],
                     "n": counts[1], "loss_rel_err": rel,
                     "grad_rel_err": grad}
        check(counts[0] == counts[1] > 0 and losses[1] > 0,
              f"duet pretrain f32 {task}: n {counts}, loss {losses}")
        check(rel <= TRAIN_TOL and grad <= TRAIN_TOL,
              f"duet pretrain f32 {task}: loss {rel}, gradients {grad}")
        if task == "sap":  # the graph bias trains sprel_linear via dBias
            g = card.bert.global_encoder.sprel_linear.weight.grad
            w = cpu.bert.global_encoder.sprel_linear.weight.grad
            err = float((g.cpu() - w).abs().max()) / max(
                float(w.abs().max()), 1e-30)
            out[task]["sprel_grad_rel_err"] = err
            check(float(w.abs().max()) > 0 and err <= TRAIN_TOL,
                  f"duet pretrain f32 sap: sprel_linear gradient {err}")
    launches = attention.launch_counts()
    check(launches["attention_fwd"] > 0 and launches["attention_bwd"] > 0
          and launches["attention_dropout_fwd"] == 0
          and launches["attention_dropout_bwd"] == 0,
          f"duet pretrain f32 launches {launches}")
    return out, launches


def duet_pretrain_phase(torch, dcfg, world):
    """`DuetPretrainer` at duet_r2r_config (`use_lang2visn_attn` on),
    batch 64, image_prob_size 1000, the bench episodes as trajectories:
    after a warm-up round one timed step of each of mlm, mrc and sap
    (`duet_pretrain_steps`: K2 / K3 from `duet_pretrain_calls`, the host's
    batch assembly beside the step, the device's busy time), `validate` on
    a held-out split (K1 only); then og at the REVERIE-DUET preset on the
    bench world with 20 objects a node, batch 8, and its `validate`; each
    task's f32 loss and gradients at batch 2 card vs CPU."""
    from vln_imagine_tpu_torch.config import reverie_config
    from vln_imagine_tpu_torch.eval.trace import bench_episodes
    from vln_imagine_tpu_torch.ops import attention
    from vln_imagine_tpu_torch.pretrain.trainer import DuetPretrainer

    fresh_phase(torch)
    t0 = time.perf_counter()
    cfg = duet_pretrain_cfg(dcfg, DUET_PRETRAIN_TASKS, DUET_PRETRAIN_BATCH)
    pt = DuetPretrainer(cfg, world, bench_episodes(world, cfg, 64),
                        image_prob_size=PRETRAIN_PROBS, device="cuda")
    pt.add_validation_split("val_unseen", world,
                            e2e_episodes(world, cfg, 32, seed=2,
                                         images=False), seed=1)
    state = pt.init_state()
    for task in DUET_PRETRAIN_TASKS:  # warm-up round
        state, _ = pt.train_step(state, task, pt.batcher.task_batch(
            task, DUET_PRETRAIN_BATCH))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    state, tasks = duet_pretrain_steps(torch, pt, state, DUET_PRETRAIN_BATCH)
    peak = torch.cuda.max_memory_allocated()
    attention.reset_launch_counts()
    t = time.perf_counter()
    val = pt.validate(state, batch_size=DUET_PRETRAIN_BATCH, num_batches=1)
    val_s = time.perf_counter() - t
    val_launches = attention.launch_counts()
    want = {"attention_fwd": sum(duet_pretrain_calls(cfg, t)
                                 for t in DUET_PRETRAIN_TASKS),
            "attention_dropout_fwd": 0, "attention_dropout_bwd": 0,
            "attention_bwd": 0}
    check(val_launches == want, f"duet validate launches {val_launches}")
    check(all(math.isfinite(v["loss"]) for v in val.values()), f"val {val}")
    del pt
    torch.cuda.empty_cache()

    # og: REVERIE-DUET's preset on the bench world with objects
    rcfg = reverie_config("duet")
    ocfg = duet_pretrain_cfg(rcfg, ("og",), DUET_OG_BATCH)
    oworld, _ = variant_world(rcfg, DUET_OG_OBJECTS)
    ops = DuetPretrainer(ocfg, oworld, bench_episodes(oworld, rcfg, 64),
                         image_prob_size=PRETRAIN_PROBS, device="cuda")
    ostate = ops.init_state()
    ostate, _ = ops.train_step(ostate, "og", ops.batcher.task_batch(
        "og", DUET_OG_BATCH))  # warm-up
    torch.cuda.reset_peak_memory_stats()
    ostate, og = duet_pretrain_steps(torch, ops, ostate, DUET_OG_BATCH)
    tasks.update(og)
    og_peak = torch.cuda.max_memory_allocated()
    attention.reset_launch_counts()
    oval = ops.validate(ostate, batch_size=DUET_OG_BATCH, num_batches=2)
    oval_launches = attention.launch_counts()
    check(oval_launches["attention_fwd"] == 2 * duet_pretrain_calls(ocfg, "og")
          and math.isfinite(oval["og"]["loss"]),
          f"og validate {oval} launches {oval_launches}")
    del ops
    torch.cuda.empty_cache()

    parity, f32_launches = duet_pretrain_parity(
        torch, cfg, world, bench_episodes(world, cfg, 8), DUET_PRETRAIN_TASKS,
        PRETRAIN_PROBS)
    og_parity, og_launches = duet_pretrain_parity(
        torch, ocfg, oworld, bench_episodes(oworld, rcfg, 8), ("og",),
        PRETRAIN_PROBS)
    parity.update(og_parity)
    f32_launches = {k: v + og_launches[k] for k, v in f32_launches.items()}
    emit({"phase": "duet_pretrain", "config": "duet_r2r_config + "
          "use_lang2visn_attn (og: reverie_config('duet'))",
          "compute_dtype": cfg.model.compute_dtype,
          "batch": DUET_PRETRAIN_BATCH, "og_batch": DUET_OG_BATCH,
          "image_prob_size": PRETRAIN_PROBS, "setup_s": setup_s,
          "tasks": tasks, "peak_mem_bytes": peak, "og_peak_mem_bytes": og_peak,
          "validate": {**val, **oval}, "validate_s": val_s,
          "validate_launches": val_launches, "f32_parity": parity,
          "f32_launches": f32_launches, "tol": TRAIN_TOL})
    runs = [r["launches"] for r in tasks.values()] + [
        val_launches, oval_launches, f32_launches]
    return {k: max(r[k] for r in runs) for k in val_launches}


# --------------------------------------------------------------- phase 6
def _case_inputs(torch, B, lq, lk, dtype, bias_kind, gen, D=HEAD_DIM):
    from vln_imagine_tpu_torch.ops.masks import extend_neg_mask

    dev, H = "cuda", HEADS
    if bias_kind == "none":  # the ViT: q, k, v views of one [B, L, 3, H, D]
        qkv = torch.randn(B, lq, 3 * H * D, device=dev, generator=gen).to(
            dtype).unflatten(-1, (3, H, D))
        do = torch.randn(B, lq, H, D, device=dev, generator=gen).to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do, None
    # q from one packed [B, Lq, 3*H*D] product, k/v from another: strided
    # views with row stride 2304, as MHAttention hands them to the kernels
    qx = torch.randn(B, lq, 3 * H * D, device=dev, generator=gen).to(dtype)
    kvx = torch.randn(B, lk, 3 * H * D, device=dev, generator=gen).to(dtype)
    q = qx[..., :H * D].unflatten(-1, (H, D))
    k, v = (x.unflatten(-1, (H, D)) for x in kvx[..., H * D:].split(H * D, -1))
    do = torch.randn(B, lq, H, D, device=dev, generator=gen).to(dtype)
    if bias_kind == "per_head":
        bias = torch.randn(B, H, lq, lk, device=dev, generator=gen)
    else:
        keep = torch.rand(B, lk, device=dev, generator=gen) < 0.8
        keep[:, 0] = True
        bias = extend_neg_mask(keep)  # [B, 1, 1, Lk]
        if bias_kind == "graph":  # + DUET's graph bias, [B, 1, Lq, Lk]
            bias = bias + torch.randn(B, 1, lq, lk, device=dev, generator=gen)
        elif bias_kind == "pad":  # DUET's pano key padding
            bias = torch.where(keep, 0.0, -1e9)[:, None, None, :]
        elif bias_kind == "imagine":  # item 0 has no imagination at all
            keep[0] = False
            bias = extend_neg_mask(keep)
        elif bias_kind == "no_objects":  # item 0's 20 object keys masked
            keep[0, -20:] = False
            bias = torch.where(keep, 0.0, -1e9)[:, None, None, :]
        elif bias_kind == "pad_rows":  # padding steps: two thirds of the
            keep[:2 * B // 3] = False  # rows have every key masked
            bias = torch.where(keep, 0.0, -1e9)[:, None, None, :]
    return q, k, v, do, bias


def _bound(nbytes: int, flops: int, dtype_name: str) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _max_err(got, want) -> float:
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want) if g is not None)


def kernel_case(torch, kernel, B, lq, lk, dtype_name, bias_kind, gen,
                bits=None, timed=False, D=HEAD_DIM, parent=None):
    """One kernel against its plain version (and, timed, against the
    library call, and for the forward against `parent`'s kernel, the C
    entry of another checkout's forward) at one shape."""
    import torch.nn.functional as F

    from vln_imagine_tpu_torch.ops import attention as A

    dtype = getattr(torch, dtype_name)
    q, k, v, do, bias = _case_inputs(torch, B, lq, lk, dtype, bias_kind, gen,
                                     D)
    scale, seed = D ** -0.5, 0x5EED_1234_ABCD
    wrapper = A.KERNELS[kernel]
    need_db = bias_kind in ("per_head", "graph")
    if kernel == "attention_fwd":
        def run():
            return (A.attention_fwd(q, k, v, bias, scale),)

        def plain():
            return (A.attention_reference(q, k, v, bias, scale),)
    elif kernel == "attention_dropout_fwd":
        def run():
            return (A.attention_dropout_fwd(q, k, v, bias, scale, DROPOUT,
                                            seed, bits),)

        def plain():
            return (A.attention_dropout_reference(q, k, v, bias, scale,
                                                  DROPOUT, seed, bits),)
    elif kernel == "attention_dropout_bwd":
        def run():
            return A.attention_dropout_bwd(q, k, v, bias, do, scale, DROPOUT,
                                           seed, bits, need_dbias=need_db)

        def plain():
            return A.attention_bwd_reference(q, k, v, bias, do, scale,
                                             DROPOUT, seed, bits)
    else:
        def run():
            return A.attention_bwd(q, k, v, bias, do, scale,
                                   need_dbias=need_db)

        def plain():
            return A.attention_bwd_reference(q, k, v, bias, do, scale)

    before = wrapper.launches
    got = run()
    want = plain()
    torch.cuda.synchronize()
    check(wrapper.launches == before + 1, f"{kernel} was not launched")
    if not need_db and len(want) == 4:
        want = want[:3]
    check(len(got) == len(want) or (len(got) == 4 and got[3] is None),
          f"{kernel} outputs")
    err = _max_err(got, want)
    tol = KERNEL_TOL[dtype_name]
    for g, w in zip(got, want):
        if g is not None:
            check(torch.allclose(g.float(), w.float(), rtol=tol, atol=tol),
                  f"{kernel} vs plain B{B} {lq}x{lk} {dtype_name} "
                  f"{bias_kind} {bits}: max abs err {err}")
    case = {"kernel": kernel, "B": B, "Lq": lq, "Lk": lk, "D": D,
            "dtype": dtype_name, "bias": bias_kind, "bits": bits,
            "max_abs_err": err, "tol": tol}
    if not timed:
        return case

    # least time: each input read once, each output written once; the
    # products' operations at the input type's peak (the dropout bits'
    # integer work is not counted)
    elt = q.element_size()
    qkv_bytes = (B * lq + 2 * B * lk) * HEADS * D * elt
    o_bytes = B * lq * HEADS * D * elt
    bias_bytes = 0 if bias is None else bias.numel() * 4
    mn = B * HEADS * lq * lk * D
    mask = None if bias is None else bias.to(dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if kernel in ("attention_fwd", "attention_dropout_fwd"):
        bound = _bound(qkv_bytes + o_bytes + bias_bytes, 4 * mn, dtype_name)
        p = DROPOUT if kernel == "attention_dropout_fwd" else 0.0

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  dropout_p=p, scale=scale)
    else:
        # reads q, k, v, dO (and the bias), writes dQ, dK, dV (and dBias)
        nbytes = (qkv_bytes + o_bytes + qkv_bytes + bias_bytes
                  + (bias_bytes if need_db else 0))
        bound = _bound(nbytes, 10 * mn, dtype_name)
        p = DROPOUT if kernel == "attention_dropout_bwd" else 0.0
        lib_stream = torch.cuda.Stream()
        lib_stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(lib_stream):
            lq_, lk_, lv_ = (x.detach().transpose(1, 2).contiguous()
                             .requires_grad_() for x in (q, k, v))
            lib_out = F.scaled_dot_product_attention(
                lq_, lk_, lv_, attn_mask=mask, dropout_p=p, scale=scale)
            lib_do = do.transpose(1, 2).contiguous()

        def library():  # SDPA's backward alone
            return torch.autograd.grad(lib_out, (lq_, lk_, lv_), lib_do,
                                       retain_graph=True)
    if parent is not None and kernel in ("attention_fwd",
                                         "attention_dropout_fwd"):
        rate = DROPOUT if kernel == "attention_dropout_fwd" else 0.0

        def parent_run():
            out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
            check(parent(*A.fwd_args(q, k, v, bias, out, scale, rate, seed,
                                     bits or "philox")) == 0,
                  "the parent's forward kernel did not launch")
            return (out,)

        check(_max_err(parent_run(), want) <= tol, "the parent's forward "
              f"kernel disagrees with plain at B{B} {lq}x{lk}")
        # in turns: kernel, parent, parent, kernel
        times = [time_ms(torch, f) for f in (run, parent_run, parent_run, run)]
        case.update(ms=(times[0] + times[3]) / 2, ms_all=[times[0], times[3]],
                    parent_ms=(times[1] + times[2]) / 2,
                    parent_ms_all=times[1:3])
    else:
        case["ms"] = time_ms(torch, run)
    # the plain dropout versions make the Philox mask in int64 ops: past
    # 10M scores a call (B 64 over 200 queries, the 960 pano rows) it takes
    # 13 to 48 ms, so it is replayed fewer times
    slow_plain = bits is not None and B * HEADS * lq * lk > 10_000_000
    case["plain_ms"] = time_ms(torch, plain, **(
        {"iters": 4, "repeats": 3} if slow_plain else {}))
    if kernel in ("attention_fwd", "attention_dropout_fwd"):
        case["library_ms"] = time_ms(torch, library)
    else:
        case["library_ms"] = time_ms(torch, library, stream=lib_stream)
    case.update(bound)
    return case


def kernels_phase(torch, parent=None):
    fresh_phase(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for B in BATCHES:  # K1: the eval path's batches, timed in bf16
        for lq, lk in SHAPES:
            for dt in ("bfloat16", "float32"):
                for bk in ("mask", "per_head"):
                    cases.append(kernel_case(torch, "attention_fwd", B, lq, lk,
                                             dt, bk, gen,
                                             timed=dt == "bfloat16",
                                             parent=parent))
    for lq, lk in TRAIN_SHAPES[len(SHAPES):]:  # K1 in a teacher step
        for dt in ("bfloat16", "float32"):
            for bk in ("mask", "per_head"):
                cases.append(kernel_case(torch, "attention_fwd", TRAIN_BATCH,
                                         lq, lk, dt, bk, gen))
    for lq, lk in TRAIN_SHAPES:  # K2-K4: the training batch
        for dt in ("bfloat16", "float32"):
            for bk in ("mask", "per_head"):
                # timed at the train step's case: bf16, mask, Philox bits
                timed = dt == "bfloat16" and bk == "mask"
                for kernel, bits in (("attention_dropout_fwd", "philox"),
                                     ("attention_dropout_fwd", "hash"),
                                     ("attention_dropout_bwd", "philox"),
                                     ("attention_dropout_bwd", "hash"),
                                     ("attention_bwd", None)):
                    cases.append(kernel_case(
                        torch, kernel, TRAIN_BATCH, lq, lk, dt, bk, gen,
                        bits=bits, timed=timed and bits != "hash",
                        parent=parent))
    for lq, lk in LONG_SHAPES:  # every kernel past one staged chunk
        for dt in ("bfloat16", "float32"):
            for bk in ("mask", "per_head"):
                timed = dt == "bfloat16" and bk == "mask"
                for kernel, bits in (("attention_fwd", None),
                                     ("attention_dropout_fwd", "philox"),
                                     ("attention_dropout_bwd", "philox"),
                                     ("attention_bwd", None)):
                    cases.append(kernel_case(
                        torch, kernel, TRAIN_BATCH, lq, lk, dt, bk, gen,
                        bits=bits, timed=timed, parent=parent))
    for lq, lk, D in FWD_EDGE_CASES:  # the forward at a chunk's edge, D 32, 128
        for dt in ("bfloat16", "float32"):
            for bk in ("mask", "per_head"):
                for kernel, bits in (("attention_fwd", None),
                                     ("attention_dropout_fwd", "philox")):
                    cases.append(kernel_case(
                        torch, kernel, TRAIN_BATCH, lq, lk, dt, bk, gen,
                        bits=bits, D=D))
    for B in BATCHES:  # K1 at DUET's eval shapes
        for lq, lk, bk in DUET_SHAPES:
            for dt in ("bfloat16", "float32"):
                cases.append(kernel_case(torch, "attention_fwd", B, lq, lk, dt,
                                         bk, gen, timed=dt == "bfloat16"))
    for lq, lk, bk in DUET_SHAPES:  # K2-K4 at DUET's training shapes
        for dt in ("bfloat16", "float32"):
            for kernel, bits in (("attention_dropout_fwd", "philox"),
                                 ("attention_dropout_bwd", "philox"),
                                 ("attention_bwd", None)):
                cases.append(kernel_case(torch, kernel, TRAIN_BATCH, lq, lk,
                                         dt, bk, gen, bits=bits,
                                         timed=dt == "bfloat16"))
    lq, lk, bk = IMAGINE_SHAPE  # every kernel, a fully masked item
    for dt in ("bfloat16", "float32"):
        for B in BATCHES:
            cases.append(kernel_case(torch, "attention_fwd", B, lq, lk, dt, bk,
                                     gen))
        for kernel, bits in (("attention_dropout_fwd", "philox"),
                             ("attention_dropout_bwd", "philox"),
                             ("attention_bwd", None)):
            cases.append(kernel_case(torch, kernel, TRAIN_BATCH, lq, lk, dt,
                                     bk, gen, bits=bits))
    for lq, lk, bk in VARIANT_SHAPES:  # the task variants' shapes
        cases.append(kernel_case(torch, "attention_fwd", 64, lq, lk,
                                 "bfloat16", bk, gen, timed=True))
        for kernel, bits in (("attention_dropout_fwd", "philox"),
                             ("attention_dropout_bwd", "philox"),
                             ("attention_bwd", None)):
            cases.append(kernel_case(torch, kernel, TRAIN_BATCH, lq, lk,
                                     "bfloat16", bk, gen, bits=bits,
                                     timed=bits is not None))
        for kernel in ("attention_fwd", "attention_bwd"):  # the f32 steps'
            cases.append(kernel_case(torch, kernel, TRAIN_BATCH, lq, lk,
                                     "float32", bk, gen))
    for dt in ("bfloat16", "float32"):  # the ViT's 197/197, no bias
        cases.append(kernel_case(torch, "attention_fwd", VIT_BATCH, *VIT_SHAPE,
                                 dt, "none", gen, timed=dt == "bfloat16"))
        cases.append(kernel_case(torch, "attention_bwd", TRAIN_BATCH,
                                 *VIT_SHAPE, dt, "none", gen,
                                 timed=dt == "bfloat16"))
    lq, lk, bk = NO_OBJECTS_SHAPE
    for dt in ("bfloat16", "float32"):
        for kernel, bits in (("attention_fwd", None),
                             ("attention_dropout_fwd", "philox"),
                             ("attention_dropout_bwd", "philox"),
                             ("attention_bwd", None)):
            cases.append(kernel_case(torch, kernel, TRAIN_BATCH, lq, lk, dt,
                                     bk, gen, bits=bits))
    for lq, lk, bk in DUET_PRETRAIN_SHAPES:  # lang2visn
        for dt in ("bfloat16", "float32"):
            timed = dt == "bfloat16"
            cases.append(kernel_case(torch, "attention_fwd",
                                     DUET_PRETRAIN_BATCH, lq, lk, dt, bk, gen,
                                     timed=timed))
            for B in (TRAIN_BATCH, DUET_PRETRAIN_BATCH)[:2 if timed else 1]:
                for kernel in ("attention_dropout_fwd",
                               "attention_dropout_bwd"):
                    cases.append(kernel_case(torch, kernel, B, lq, lk, dt, bk,
                                             gen, bits="philox", timed=timed))
            cases.append(kernel_case(torch, "attention_bwd", TRAIN_BATCH, lq,
                                     lk, dt, bk, gen))
    lq, lk, bk = PANO_ROWS_SHAPE  # the pano encoder over whole trajectories
    for dt in ("bfloat16", "float32"):
        for kernel, bits in (("attention_fwd", None),
                             ("attention_dropout_fwd", "philox"),
                             ("attention_dropout_bwd", "philox"),
                             ("attention_bwd", None)):
            cases.append(kernel_case(torch, kernel, PANO_ROWS, lq, lk, dt, bk,
                                     gen, bits=bits, timed=dt == "bfloat16"))
    emit({"phase": "kernels", "cases": cases,
          "duet_weighted": duet_weighted(cases),
          "fwd_deterministic": determinism(torch, gen, "attention_dropout_fwd"),
          "bwd_deterministic": determinism(torch, gen, "attention_dropout_bwd")})
    return cases


def duet_weighted(cases) -> dict:
    """Launch-weighted bf16 times of each kernel over one DUET step (the 18
    per-step calls at the released config) and over the language stack (9
    calls), beside SDPA's and the bound, and the share of the step's time
    that falls on the two cross-attentions over 220 keys."""
    out = {}
    for kernel, B in (("attention_fwd", 64), ("attention_fwd", 8),
                      ("attention_dropout_fwd", 8),
                      ("attention_dropout_bwd", 8), ("attention_bwd", 8)):
        row = {}
        for lq, lk, bk in DUET_SHAPES:
            row[(lq, lk)] = next(
                c for c in cases if c["kernel"] == kernel and c["B"] == B
                and (c["Lq"], c["Lk"], c["bias"], c["dtype"])
                == (lq, lk, bk, "bfloat16") and "ms" in c)
        entry = {}
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            step = sum(n * row[shape][key]
                       for shape, n in DUET_STEP_CALLS.items())
            entry[f"step_{key}"] = step
            entry[f"text_{key}"] = DUET_TEXT_CALLS * row[(200, 200)][key]
        entry["step_long_key_share"] = sum(
            n * row[shape]["ms"] for shape, n in DUET_STEP_CALLS.items()
            if shape[1] == 220) / entry["step_ms"]
        entry["per_call_ms"] = {f"{lq}/{lk}": row[(lq, lk)]["ms"]
                                for lq, lk, _ in DUET_SHAPES}
        out[f"{kernel} B{B}"] = entry
    return out


def determinism(torch, gen, kernel) -> list:
    """Two K2 (or K3) calls with one seed give the same bits (no atomics),
    K3's dBias included, in both dtypes, at a training and a long shape."""
    from vln_imagine_tpu_torch.ops import attention as A

    out = []
    for lq, lk in ((80, 67), LONG_SHAPES[-1]):
        for dt in ("bfloat16", "float32"):
            q, k, v, do, bias = _case_inputs(torch, TRAIN_BATCH, lq, lk,
                                             getattr(torch, dt), "per_head",
                                             gen)
            if kernel == "attention_dropout_fwd":
                first, second = ((A.attention_dropout_fwd(
                    q, k, v, bias, HEAD_DIM ** -0.5, DROPOUT, 0xD5EED),)
                    for _ in range(2))
            else:
                first, second = (A.attention_dropout_bwd(
                    q, k, v, bias, do, HEAD_DIM ** -0.5, DROPOUT, 0xD5EED,
                    need_dbias=True) for _ in range(2))
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(first, second))
            check(same, f"two {kernel} calls differ at {lq}x{lk} {dt}")
            out.append({"Lq": lq, "Lk": lk, "dtype": dt, "identical": same})
    return out


def build_parent_fwd(parent: Path):
    """The C entry `vln_attention_fwd` of another checkout's forward source
    (`--parent`), built with this checkout's flags, to time it beside this
    one's kernel on the same inputs.  Its arguments are the same."""
    import ctypes

    from torch.utils.cpp_extension import CUDA_HOME

    from vln_imagine_tpu_torch.ops import attention as A

    src = parent / KERNEL_SOURCES[0]
    check(src.is_file(), f"--parent: no {src}")
    out = A.BUILD_DIR / "parent_attention_fwd.so"
    A.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME else "nvcc"
    subprocess.run([nvcc, *A.NVCC_FLAGS, "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True, timeout=600)
    fn = ctypes.CDLL(str(out)).vln_attention_fwd
    fn.argtypes = A._ARGTYPES["vln_attention_fwd"]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose forward kernel (K1, K2) is "
                         "timed beside this one's in the kernels phase")
    args = ap.parse_args()
    missing = [s for s in KERNEL_SOURCES if not (ROOT / s).is_file()]
    if missing:
        print("chip_smoke: run it from a checkout of the repository "
              f"({missing} missing)", file=sys.stderr)
        raise SystemExit(2)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(3)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vln_imagine_tpu_torch.config import duet_r2r_config, hamt_r2r_config
    from vln_imagine_tpu_torch.eval.trace import bench_world
    from vln_imagine_tpu_torch.ops import attention

    t = time.perf_counter()
    libs = attention.load_kernels()
    parent = None if args.parent is None else build_parent_fwd(args.parent)
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "libraries": [Path(lib._name).name for lib in libs.values()],
          "nvcc_flags": attention.NVCC_FLAGS,
          "parent": None if args.parent is None else str(args.parent)})

    cfg, dcfg = hamt_r2r_config(), duet_r2r_config()
    world = bench_world(cfg)  # DUET's released config reads the same world
    path_launches = {"eval": main_path_phase(torch, cfg, world)}
    parity_phase(torch, cfg, world)
    path_launches["train"] = train_phase(torch, cfg, world)
    path_launches["train_parity"] = train_parity_phase(torch, cfg, world)
    path_launches["duet_eval"] = duet_eval_phase(torch, dcfg, world)
    duet_parity_phase(torch, dcfg, world)
    path_launches["duet_train"] = duet_train_phase(torch, dcfg, world)
    path_launches["duet_train_parity"] = duet_train_parity_phase(torch, dcfg,
                                                                 world)
    with scratch_dir() as tmp:
        path_launches["driver_hamt"] = driver_phase(torch, cfg, Path(tmp))
    with scratch_dir() as tmp:
        path_launches["driver_duet"] = driver_phase(torch, dcfg, Path(tmp))
    with scratch_dir() as tmp:
        path_launches["train_cli"] = cli_phase(
            torch, Path(tmp), "train_cli",
            ["--synthetic", "--iters", "2", "--log-every", "1"])
    path_launches["hamt_train_variants"] = hamt_train_variants_phase(
        torch, cfg, world)
    path_launches["duet_train_variants"] = duet_train_variants_phase(
        torch, dcfg, world)
    path_launches["duet_eval_variants"] = duet_eval_variants_phase(
        torch, dcfg, world)
    with scratch_dir() as tmp:
        path_launches["train_cli_duet"] = cli_phase(
            torch, Path(tmp), "train_cli_duet",
            ["--agent", "duet", "--synthetic", "--detailed-output",
             "--expl-sample", "--iters", "2", "--log-every", "1"],
            CLI_FILES + ("detail_val_unseen.json",), after=duet_details)
    path_launches.update(variants_phase(torch))
    path_launches.update(variants_f32_parity_phase(torch))
    path_launches["variant_driver"] = variant_driver_phase(torch)
    with scratch_dir() as tmp:
        path_launches["train_cli_r2r_back"] = r2r_back_cli(torch, Path(tmp))
    path_launches["vit_extract"] = vit_extract_phase(torch)
    path_launches["e2e_finetune"] = e2e_finetune_phase(torch, cfg, dcfg, world)
    path_launches["e2e_train_parity"] = e2e_train_parity_phase(torch, cfg,
                                                               world)
    path_launches["hamt_pretrain"] = hamt_pretrain_phase(torch, cfg, world)
    path_launches["e2e_pretrain"] = e2e_pretrain_phase(torch, cfg, world)
    path_launches["duet_pretrain"] = duet_pretrain_phase(torch, dcfg, world)
    with scratch_dir() as tmp:
        path_launches["pretrain_cli"] = pretrain_cli_phase(torch, Path(tmp))
    cases = kernels_phase(torch, parent)

    summary = []
    for name, (source, replaces) in KERNELS.items():
        mine = [c for c in cases if c["kernel"] == name]
        rep = next(c for c in mine if "ms" in c and (
            c["B"], c["Lq"], c["Lk"], c["dtype"], c["bias"])
            == REPRESENTATIVE[name])
        by_path = {p: n[name] for p, n in path_launches.items()}
        check(max(by_path.values()) > 0, f"{name} launched on no path")
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": max(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
            "at": (f"B{rep['B']} Lq{rep['Lq']} Lk{rep['Lk']} H12 D64 bf16, "
                   f"[B,1,1,Lk] mask, packed q/k/v"
                   + (f", {rep['bits']} bits" if rep["bits"] else "")),
        })
    emit({"kernels": summary})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
