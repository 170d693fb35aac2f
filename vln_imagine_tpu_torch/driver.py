"""Fine-tune training driver: the main.py train/valid loop.

Rebuild of VLN-HAMT/finetune_src/r2r/main.py:138-461 (HAMT) /
VLN-DUET/map_nav_src/r2r/main_nav.py (DUET): train in log_every intervals,
validate each val split greedily, keep best (spl+sr for HAMT, spl for DUET) /
latest / periodic snapshots, append record files and scalar logs.  The
3-stage warm-up lives inside the optimizer schedule (train/optim.py), so the
driver needs none of the reference's per-interval LR/freeze mutation
(main.py:200-278).

The port of `vln_imagine_tpu/driver.py`.  The trainer's modules hold the
weights and its optimizers the moments, so the driver's state is the
trainer itself; a checkpoint slot holds it in the reference's agent-save
layout ({vln_bert, critic} x {epoch, state_dict, optimizer},
agent_cmt.py:837-852; DUET's DAgger recipe has no critic).  The trainer's
`Rng` is not saved, as the JAX driver's key is not.  Everything runs on the
card unless the caller names a device.

DUET's `detailed_output` evaluates with the final stop table and writes it
into `detail_<split>.json` (main_nav.py:384).  Validation scores each
task variant by its own metrics (variants.py): REVERIE / SOON by object
navigation and grounding (RGS, RGSPL, `predObjId` in the submission),
r2r_back by the declared midstop, CVDN by goal progress over the split's
`end_panos`.  `init_from_pretrain` grafts a snapshot of the port's
pre-trainer (pretrain/trainer.py) into the navigator.  Not ported yet, and
refused with NotImplementedError: a device mesh (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from vln_imagine_tpu_torch.ckpt.manager import CheckpointManager
from vln_imagine_tpu_torch.config import Config
from vln_imagine_tpu_torch.data.annotations import EvalSampler, RoundRobinSampler
from vln_imagine_tpu_torch.envx.tables import EpisodeBatch, WorldTables
from vln_imagine_tpu_torch.eval.metrics import eval_batch
from vln_imagine_tpu_torch.variants import eval_batch_variant
from vln_imagine_tpu_torch.utils.logger import (
    MetricsWriter,
    dump_args,
    write_to_record_file,
)


@dataclass
class SplitData:
    name: str
    episodes: EpisodeBatch          # full split, host-side arrays
    instr_ids: list = field(default_factory=list)
    # NDH (cvdn): the annotated goal-pano node indices per item, used by
    # goal-progress eval (NDHNavBatch, VLN-HAMT/finetune_src/cvdn/env.py:91-130)
    end_panos: list | None = None


def _take(ep: EpisodeBatch, idxs: np.ndarray) -> EpisodeBatch:
    # numpy gather only: the train / eval step copies the batch to the device
    return dataclasses.replace(ep, **{
        f.name: None if getattr(ep, f.name) is None
        else np.asarray(getattr(ep, f.name))[idxs]
        for f in dataclasses.fields(ep)})


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def refuse_unported(cfg: Config) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for a
    configuration whose branch the port does not have yet."""
    unported = [
        (cfg.mesh.data_parallelism != 0, "a device mesh (data parallelism)",
         7),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP Queue 1 item {item}")


class FinetuneDriver:
    def __init__(self, cfg: Config, tables: WorldTables,
                 train_split: SplitData, val_splits: list[SplitData],
                 log_dir: str, graphs=None,
                 aug_split: SplitData | None = None, device=None):
        refuse_unported(cfg)
        self.cfg = cfg
        self.tables = tables
        # host copy of the distance tables, for the metrics
        self._dist = _host(tables.dist)
        # host ScanGraphs (scan index -> graph): needed only to emit
        # submit_<env>.json with real viewpoint ids/poses (main.py:416-421)
        self.graphs = graphs
        self.train_split = train_split
        self.val_splits = val_splits
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        dump_args(cfg, log_dir)
        self.writer = MetricsWriter(log_dir)
        self.record_file = os.path.join(log_dir, "train.txt")
        self.ckpt = CheckpointManager(
            os.path.join(log_dir, "ckpts"),
            select_metric="spl_sr" if cfg.agent == "hamt" else "spl")

        if cfg.agent == "hamt":
            from vln_imagine_tpu_torch.train.trainer import HamtTrainer
            self.trainer = HamtTrainer(cfg, tables, device=device)
            # train_alg 'sample' = IL+RL (agent_cmt.py:799-832);
            # 'imitation' = teacher-forced CE only
            self._feedback = ("teacher"
                              if cfg.train.train_alg == "imitation"
                              else "sample")
        else:
            from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer
            self.trainer = DuetTrainer(cfg, tables, device=device)
            self._feedback = None  # train_alg drives it
        self.device = self.trainer.device
        self.sampler = RoundRobinSampler(
            train_split.episodes.scan.shape[0], cfg.train.batch_size,
            cfg.train.seed)
        # augmented-data split (main.py:98-108,281-302): training alternates
        # one GT iteration with one augmented iteration.  Aug episodes carry
        # no imaginations (imagine_mask all False): with every imagination
        # token masked the additive -10000 attention masks zero its
        # contribution, matching the reference's imagine_enc_pano=False flip.
        self.aug_split = aug_split
        self.aug_sampler = (RoundRobinSampler(
            aug_split.episodes.scan.shape[0], cfg.train.batch_size,
            cfg.train.seed + 1) if aug_split is not None else None)
        self._train_step: Callable | None = None
        self._eval_step: Callable | None = None
        self._eval_detailed = False
        # host seconds of each train interval and validation pass, and the
        # step count of every eval batch's loop (what its kernel launches
        # follow)
        self.timings: dict[str, list] = {"train": [], "validate": []}
        self.eval_step_counts: list[int] = []

    # ------------------------------------------------------------------ init
    def setup(self, init_state_dict: dict | None = None):
        """Build the train and eval steps; `init_state_dict` (the
        navigator's state_dict) replaces the seeded init."""
        if init_state_dict is not None:
            self.trainer.model.load_state_dict(init_state_dict)
        if self.cfg.agent == "hamt":
            self._train_step = self.trainer.make_train_step(self._feedback)
        else:
            self._train_step = self.trainer.make_train_step()
        # DUET --detailed_output: the eval step also returns the final
        # per-map-node stop table for the 'details' submission field
        self._eval_detailed = (self.cfg.agent == "duet"
                               and self.cfg.train.detailed_output)
        self._eval_step = (self.trainer.make_eval_step(detailed=True)
                           if self._eval_detailed
                           else self.trainer.make_eval_step())

    def state_dict(self) -> dict:
        """The training state in the reference's agent-save layout.  The
        tensors are the live ones: clone them to keep a copy."""
        tr = self.trainer
        step = tr.optimizer.steps
        state = {"vln_bert": {"epoch": step,
                              "state_dict": tr.model.state_dict(),
                              "optimizer": tr.optimizer.state_dict()}}
        if getattr(tr, "critic", None) is not None:
            state["critic"] = {"epoch": step,
                               "state_dict": tr.critic.state_dict(),
                               "optimizer": tr.critic_optimizer.state_dict()}
        return state

    def load_state_dict(self, state: dict) -> None:
        """Restore `state_dict()`'s output in place: the optimizers keep
        their references to the modules' parameters."""
        tr = self.trainer
        tr.model.load_state_dict(state["vln_bert"]["state_dict"])
        tr.optimizer.load_state_dict(state["vln_bert"]["optimizer"])
        if "critic" in state:
            tr.critic.load_state_dict(state["critic"]["state_dict"])
            tr.critic_optimizer.load_state_dict(state["critic"]["optimizer"])

    def load_checkpoint(self, name: str) -> dict:
        """Restore the slot `name` (or a checkpoint path) into the trainer;
        refuses a checkpoint of a differently configured model."""
        state = self.ckpt.load(name, self.state_dict(),
                               map_location=self.device)
        self.load_state_dict(state)
        return state

    def init_from_reference(self, path: str) -> dict:
        """Initialize from a released torch agent checkpoint — the
        {vln_bert, critic} x {epoch, state_dict, optimizer} format the
        reference agents save (agent_cmt.py:837-875), including DDP
        'module.' prefix healing (agent_base.py:250-282) — with a native
        `load_state_dict`.  Optimizer states stay as they are (the
        reference's load defaults to resume_optimizer=False too).  Returns
        {'epoch', 'skipped'}."""
        from vln_imagine_tpu_torch.ckpt.manager import load_reference_checkpoint

        loaded = load_reference_checkpoint(path, agent=self.cfg.agent)
        model = self.trainer.model
        want = model.state_dict()
        sd = loaded["state_dict"]
        missing = [k for k in want if k not in sd]
        if missing:
            raise ValueError(f"reference checkpoint '{path}' does not cover "
                             f"this model: missing {missing[:8]}")
        model.load_state_dict({k: sd[k] for k in want})
        critic = getattr(self.trainer, "critic", None)
        if loaded.get("critic_state_dict") and critic is not None:
            critic.load_state_dict(loaded["critic_state_dict"])
        return {"epoch": loaded.get("epoch"),
                "skipped": loaded["skipped"] + [k for k in sd
                                                if k not in want]}

    def init_from_bert_ckpt(self, path: str) -> dict:
        """The reference's --bert_ckpt_file on-ramp: initialize the
        navigator from a released torch pre-train checkpoint (flat
        model_step_<N>.pt state_dict, vlnbert_init.py:20-31 incl.
        'module.' healing and the next_action head transfer).  Shared
        submodules take the pre-trained values; fine-tune-only modules
        (imagination, aux head, critic) stay at init; pretrain-only heads
        are skipped.  Returns {'transferred', 'missing', 'skipped'}."""
        from vln_imagine_tpu_torch.ckpt.convert import (
            flax_from_state_dict,
            state_dict_from_flax,
        )
        from vln_imagine_tpu_torch.ckpt.manager import load_reference_pretrain
        from vln_imagine_tpu_torch.ckpt.transfer import (
            init_finetune_from_pretrain,
        )

        agent = self.cfg.agent
        loaded = load_reference_pretrain(path, agent=agent)
        model = self.trainer.model
        new_params, transferred, missing = init_finetune_from_pretrain(
            flax_from_state_dict(model.state_dict(), agent),
            flax_from_state_dict(loaded["state_dict"], agent))
        if transferred == 0:
            raise ValueError(f"no parameter subtree of '{path}' matched the "
                             f"{agent} fine-tune model")
        model.load_state_dict(state_dict_from_flax(new_params, agent))
        return {"transferred": transferred, "missing": missing,
                "skipped": loaded["skipped"]}

    def init_from_pretrain(self, path: str) -> dict:
        """Initialize the navigator from a pre-training snapshot
        (`model_step_<N>`, the port's pre-trainer's `torch.save` of its
        model's state_dict: the reference's ModelSaver file,
        pretrain_src/utils/save.py:23-46, consumed at fine-tune model
        construction, vlnbert_init.py:20-31).  Shared submodules take the
        pre-trained values; fine-tune-only modules (imagination, critic,
        aux head) stay at init.  Returns {'transferred', 'missing'}."""
        from vln_imagine_tpu_torch.ckpt.convert import (
            flax_from_state_dict,
            state_dict_from_flax,
        )
        from vln_imagine_tpu_torch.ckpt.transfer import (
            init_finetune_from_pretrain,
        )

        agent = self.cfg.agent
        snapshot = torch.load(path, map_location="cpu", weights_only=True)
        model = self.trainer.model
        new_params, transferred, missing = init_finetune_from_pretrain(
            flax_from_state_dict(model.state_dict(), agent),
            flax_from_state_dict(snapshot, f"{agent}_pretrain"))
        if transferred == 0:
            raise ValueError(f"no parameter subtree of '{path}' matched the "
                             f"{agent} fine-tune model")
        model.load_state_dict(state_dict_from_flax(new_params, agent))
        return {"transferred": transferred, "missing": missing}

    # ----------------------------------------------------------------- train
    def train_interval(self, n_iters: int) -> dict:
        """`n_iters` train steps; the metrics stay on the device until the
        interval's end, where one host sync reads their means."""
        t0 = time.perf_counter()
        logs: dict[str, list] = {}
        for it in range(n_iters):
            # with an aug split: odd iterations draw augmented batches
            # (main.py:285-302's 1 GT / 1 aug alternation)
            use_aug = self.aug_split is not None and it % 2 == 1
            sampler = self.aug_sampler if use_aug else self.sampler
            split = self.aug_split if use_aug else self.train_split
            ep1 = _take(split.episodes, sampler.next_batch())
            ep2 = _take(split.episodes, sampler.next_batch())
            metrics = self._train_step(ep1, ep2)
            for k, v in metrics.items():
                logs.setdefault(k, []).append(v)
        keys = list(logs)
        means = torch.stack([torch.stack(logs[k]).float().mean()
                             for k in keys]).tolist()
        self.timings["train"].append(
            {"seconds": time.perf_counter() - t0, "iters": n_iters})
        return dict(zip(keys, means))

    # ------------------------------------------------------------------ eval
    def validate(self, split: SplitData, batch_size: int | None = None,
                 write_outputs: bool = False) -> dict:
        t0 = time.perf_counter()
        bs = (batch_size or self.cfg.train.eval_batch_size
              or self.cfg.train.batch_size)
        n = split.episodes.scan.shape[0]
        # a batch bigger than the split only pads compute (EvalSampler wraps)
        bs = max(min(bs, n), 1)
        paths, gts, scans, kept_ids, kept_idx = [], [], [], [], []
        extra = []  # pred_obj (reverie/soon) or declared midstop (r2r_back)
        details = []  # per item {node: stop probability} (detailed_output)
        # a window of eval calls in flight (VLN_EVAL_PIPELINE, default 4;
        # 1 is fully synchronous).  The port's eval step waits for the
        # device once a step for its early exit, so a call returns with its
        # work done and the window gives no overlap; it is kept so that a
        # step that does not wait keeps the JAX package's semantics.
        depth = max(int(os.environ.get("VLN_EVAL_PIPELINE", "4")), 1)
        # length bucketing (VLN_EVAL_BUCKET=0 disables): the early-exit
        # loop runs every batch to its SLOWEST episode, so grouping
        # episodes by expected length (gt path length as the proxy) cuts the
        # steps wasted on already-ended items.  Pure scheduling: each item's
        # rollout is independent of its batchmates (ended items are frozen),
        # so per-item results are identical to sequential order.
        if os.environ.get("VLN_EVAL_BUCKET", "1") != "0" and n > bs:
            gt_len = np.asarray(split.episodes.gt_len)
            perm = np.argsort(gt_len, kind="stable").astype(np.int64)
        else:
            perm = np.arange(n, dtype=np.int64)
        inflight: deque = deque()
        sampler = iter(EvalSampler(n, bs))
        exhausted = False
        gt_path = np.asarray(split.episodes.gt_path)
        gt_len = np.asarray(split.episodes.gt_len)
        scan = np.asarray(split.episodes.scan)
        while inflight or not exhausted:
            while not exhausted and len(inflight) < depth:
                nxt = next(sampler, None)
                if nxt is None:
                    exhausted = True
                    break
                pos, fresh = nxt
                idxs = perm[pos]
                out = self._eval_step(_take(split.episodes, idxs))
                self.eval_step_counts.append(self._eval_step.steps)
                inflight.append((idxs, fresh, out))
            if not inflight:
                break
            idxs, fresh, out = inflight.popleft()
            if self._eval_detailed:
                det_nodes, det_scores, det_valid = (x.cpu().numpy()
                                                    for x in out[-1])
                out = out[:-1]
            pn, pl = out[0].cpu().numpy(), out[1].cpu().numpy()
            po = out[2].cpu().numpy() if len(out) > 2 else None
            for j, keep in enumerate(fresh):
                if not keep:
                    continue
                b = idxs[j]
                paths.append(list(pn[j, :pl[j]]))
                gts.append(list(gt_path[b][:int(gt_len[b])]))
                scans.append(int(scan[b]))
                kept_ids.append(split.instr_ids[b] if split.instr_ids else b)
                kept_idx.append(b)
                if po is not None:
                    extra.append(int(po[j]))
                if self._eval_detailed:
                    details.append({int(n): float(s) for n, s, v in zip(
                        det_nodes[j], det_scores[j], det_valid[j]) if v})
        is_obj = bool(extra) and split.episodes.gt_obj_id is not None
        if is_obj:
            # REVERIE/SOON: object-navigation scoring (success = stop at any
            # viewpoint the gt object is visible from; RGS/RGSPL grounding)
            avg, per = self._eval_object_split(split, scans, paths, gts,
                                               kept_ids, kept_idx, extra)
        elif (self.cfg.dataset == "r2r_back"
              and split.episodes.midstop is not None):
            gt_mid = np.asarray(split.episodes.midstop)
            avg, per = eval_batch_variant(
                "r2r_back", self._dist, np.asarray(scans), paths,
                gt_paths=gts,
                midstops=[(m if m >= 0 else None) for m in extra],
                gt_midstops=[int(gt_mid[b]) for b in kept_idx],
                instr_ids=kept_ids)
        elif self.cfg.dataset == "cvdn" and split.end_panos is not None:
            avg, per = eval_batch_variant(
                "cvdn", self._dist, np.asarray(scans), paths, gt_paths=gts,
                end_panos=[split.end_panos[b] for b in kept_idx],
                instr_ids=kept_ids)
        else:
            avg, per = eval_batch(self._dist, np.asarray(scans),
                                  paths, gts, kept_ids)
        if write_outputs:
            # submit_<env>.json + individual_metrics_<env>.json
            # (main.py:410-421); the submission needs host graphs for real
            # viewpoint ids/poses
            from vln_imagine_tpu_torch.eval.submission import (
                write_individual_metrics,
                write_submission,
            )
            write_individual_metrics(
                os.path.join(self.log_dir,
                             f"individual_metrics_{split.name}.json"), per)
            if self.graphs is not None:
                headings = np.asarray(split.episodes.start_heading)[kept_idx]
                prefix = "detail" if details else "submit"  # main_nav.py:384
                write_submission(
                    os.path.join(self.log_dir, f"{prefix}_{split.name}.json"),
                    self.graphs, np.asarray(scans), paths, kept_ids, headings,
                    details=details or None,
                    pred_obj_ids=extra if is_obj else None)
        self.timings["validate"].append(
            {"seconds": time.perf_counter() - t0, "items": n,
             "split": split.name})
        return avg

    def _eval_object_split(self, split, scans, paths, gts, kept_ids,
                           kept_idx, pred_objs):
        gt_obj = np.asarray(split.episodes.gt_obj_id)
        obj_ids = _host(self.tables.obj_ids)       # [S, N, Ko]
        obj_valid = _host(self.tables.obj_valid)
        gt_objs, goal_vps = [], []
        for i, b in enumerate(kept_idx):
            g = int(gt_obj[b])
            gt_objs.append(g)
            visible = (obj_ids[scans[i]] == g) & obj_valid[scans[i]]
            vps = list(np.nonzero(np.any(visible, axis=-1))[0])
            # fall back to the annotated goal if the object table lacks it
            goal_vps.append(vps if vps else [gts[i][-1]])
        variant = (self.cfg.dataset if self.cfg.dataset in ("reverie", "soon")
                   else "reverie")
        return eval_batch_variant(
            variant, self._dist, np.asarray(scans), paths, gt_paths=gts,
            goal_viewpoints=goal_vps, pred_objs=pred_objs, gt_objs=gt_objs,
            instr_ids=kept_ids)

    # ------------------------------------------------------------------ loop
    def _train_interval_profiled(self, interval: int, profile_dir: str):
        """VLN_PROFILE_DIR=<dir>: a torch.profiler trace of the interval
        (host and, on the card, device activity), written to <dir> as a
        chrome trace for TensorBoard or Perfetto."""
        from torch.profiler import (
            ProfilerActivity,
            profile,
            tensorboard_trace_handler,
        )

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        with profile(activities=acts,
                     on_trace_ready=tensorboard_trace_handler(profile_dir)):
            return self.train_interval(interval)

    def run(self, iters: int | None = None, log_every: int | None = None,
            max_failures: int = 3):
        """Training loop.  The reference has no failure handling (recovery is
        manual via --resume_file, SURVEY §5); here transient interval
        failures roll back to the latest checkpoint up to `max_failures`
        times before re-raising."""
        cfg = self.cfg
        iters = iters or cfg.train.iters
        log_every = log_every or cfg.train.log_every
        if self._train_step is None:
            self.setup()
        # seed the rollback target: without it, a first-interval failure
        # (e.g. the non-finite-loss guard firing before any save) would
        # "roll back" to nothing and keep training the poisoned in-memory
        # state for max_failures more intervals
        self.ckpt.save_latest(self.state_dict())
        start = time.time()
        failures = 0
        # profiling: VLN_PROFILE_DIR=<dir> traces the first interval.  The
        # reference offers only a tic/toc Timer (utils/logger.py:28-57).
        profile_dir = os.environ.get("VLN_PROFILE_DIR")
        for idx in range(0, iters, log_every):
            interval = min(log_every, iters - idx)
            it = idx + interval
            try:
                if profile_dir and idx == 0:
                    train_metrics = self._train_interval_profiled(
                        interval, profile_dir)
                else:
                    train_metrics = self.train_interval(interval)
                # numerical-health guard: a NaN/inf interval loss would not
                # raise on its own — once params are poisoned every later
                # step is garbage, so treat it as an interval failure and
                # take the same rollback path (checked once per interval at
                # the existing host sync; no per-step device syncs added).
                # Only loss metrics gate the rollback: an auxiliary metric
                # can be legitimately NaN for an interval (e.g. a mean over
                # an empty supervision subset) without touching params.
                bad = {k: v for k, v in train_metrics.items()
                       if "loss" in k and not np.isfinite(v)}
                if bad:
                    raise FloatingPointError(
                        f"non-finite training metrics {bad}")
                failures = 0
            except Exception as e:  # noqa: BLE001 - deliberate recovery scope
                failures += 1
                write_to_record_file(
                    f"[failure {failures}/{max_failures}] interval at iter "
                    f"{idx} failed: {type(e).__name__}: {e}",
                    self.record_file, verbose=True)
                if failures > max_failures:
                    raise
                try:
                    self.load_checkpoint("latest_dict")
                    write_to_record_file("rolled back to latest_dict",
                                         self.record_file, verbose=True)
                except Exception:
                    write_to_record_file(
                        "no checkpoint to roll back to; continuing with the "
                        "in-memory state", self.record_file, verbose=True)
                continue
            self.writer.add_scalars(train_metrics, it, prefix="loss")
            loss_str = f"iter {it}"
            for split in self.val_splits:
                score = self.validate(split)
                self.writer.add_scalars(score, it, prefix=split.name)
                loss_str += f", {split.name} " + ", ".join(
                    f"{k}: {v:.2f}" for k, v in score.items())
                if split.name.startswith("val_unseen"):
                    if it % 2000 == 0:
                        self.ckpt.save_snapshot(self.state_dict(), it,
                                                score["sr"], score["spl"],
                                                split.name)
                    self.ckpt.maybe_save_best(self.state_dict(), split.name,
                                              score)
            self.ckpt.save_latest(self.state_dict())
            write_to_record_file(
                f"[{time.time() - start:.0f}s] {loss_str} | "
                + ", ".join(f"{k}={v:.4f}" for k, v in train_metrics.items()),
                self.record_file, verbose=True)
        return self.state_dict()
