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
pre-trainer (pretrain/trainer.py) into the navigator.

Data parallelism (`mesh`, or `cfg.mesh.data_parallelism` != 0 over an
initialized process group; parallel/): one process per device, every
process running the same seeded sampler and taking its block of rows of
each global batch, so a step equals the one-process step on the whole
batch.  The state is broadcast from rank 0 after `setup`, every load and
every rollback; `validate` rounds its batch to the data axis, each rank
evaluates its rows and the per-item results are gathered, so the scores
and the files equal the one-process run's.  Only rank 0 writes logs,
checkpoints and submissions; a fault on any rank rolls every rank back.
A model axis above 1 (`cfg.mesh.model_parallelism`; parallel/tensor.py)
splits the large parameters and their optimizer moments over its ranks,
as the JAX driver's `param_shardings`: `state_dict()` gathers them whole
(every rank calls it; rank 0 writes), and every load, rollback and
on-ramp reads whole tensors and keeps this rank's slice.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from vln_imagine_tpu_torch.ckpt.manager import CheckpointManager
from vln_imagine_tpu_torch.config import Config
from vln_imagine_tpu_torch.data.annotations import EvalSampler, RoundRobinSampler
from vln_imagine_tpu_torch.envx.tables import EpisodeBatch, WorldTables
from vln_imagine_tpu_torch.eval.metrics import eval_batch
from vln_imagine_tpu_torch.parallel.distributed import (
    all_gather_objects,
    is_default_process,
    merge_results,
)
from vln_imagine_tpu_torch.parallel.mesh import (
    DataShard,
    make_mesh,
    replicate,
    shard_batch,
)
from vln_imagine_tpu_torch.parallel.tensor import gather_state, load_sharded
from vln_imagine_tpu_torch.platform import resolve_device
from vln_imagine_tpu_torch.variants import eval_batch_variant
from vln_imagine_tpu_torch.utils import spans
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


class FinetuneDriver:
    def __init__(self, cfg: Config, tables: WorldTables,
                 train_split: SplitData, val_splits: list[SplitData],
                 log_dir: str, graphs=None,
                 aug_split: SplitData | None = None, device=None, mesh=None):
        device = resolve_device(device)
        if mesh is None and cfg.mesh.data_parallelism != 0:
            mesh = make_mesh(data=cfg.mesh.data_parallelism,
                             model=cfg.mesh.model_parallelism,
                             device_type=device.type)
        self.mesh = mesh
        self.shard = None if mesh is None else DataShard.of(mesh)
        if self.shard is not None and cfg.train.batch_size % self.shard.size:
            raise ValueError(f"the data axis ({self.shard.size}) must divide "
                             f"the batch size ({cfg.train.batch_size})")
        # rank 0 writes logs, checkpoints and submissions
        self.writes = is_default_process()
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
        self.writer = None
        if self.writes:
            os.makedirs(log_dir, exist_ok=True)
            dump_args(cfg, log_dir)
            self.writer = MetricsWriter(log_dir)
        self.record_file = os.path.join(log_dir, "train.txt")
        self.ckpt = CheckpointManager(
            os.path.join(log_dir, "ckpts"),
            select_metric="spl_sr" if cfg.agent == "hamt" else "spl")

        if cfg.agent == "hamt":
            from vln_imagine_tpu_torch.train.trainer import HamtTrainer
            self.trainer = HamtTrainer(cfg, tables, device=device, mesh=mesh)
            # train_alg 'sample' = IL+RL (agent_cmt.py:799-832);
            # 'imitation' = teacher-forced CE only
            self._feedback = ("teacher"
                              if cfg.train.train_alg == "imitation"
                              else "sample")
        else:
            from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer
            self.trainer = DuetTrainer(cfg, tables, device=device, mesh=mesh)
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
            load_sharded(self.trainer.model, init_state_dict)
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
        self._replicate()

    def _replicate(self) -> None:
        """Under a mesh, broadcast the modules and the optimizer states from
        rank 0 (every rank seeds the same init and loads the same files;
        this keeps them equal whatever happened on the way)."""
        if self.mesh is None:
            return
        tr = self.trainer
        replicate(tr.model, self.mesh)
        replicate(tr.optimizer.state_dict(), self.mesh)
        if getattr(tr, "critic", None) is not None:
            replicate(tr.critic, self.mesh)
            replicate(tr.critic_optimizer.state_dict(), self.mesh)

    def _rows(self, idxs: np.ndarray) -> np.ndarray:
        """This rank's block of a global batch's item indices."""
        return idxs if self.mesh is None else shard_batch(idxs, self.mesh)

    def _record(self, line: str) -> None:
        if self.writes:
            write_to_record_file(line, self.record_file, verbose=True)

    def _barrier(self) -> None:
        """Under a mesh, wait for every rank."""
        if self.mesh is not None:
            torch.distributed.barrier()

    def _save(self, kind: str, *args) -> None:
        """Rank 0 saves the slot (`save_latest`, `save_snapshot`,
        `maybe_save_best`); the others take part in gathering the state
        and wait for it."""
        state = self.state_dict()
        if self.writes:
            getattr(self.ckpt, kind)(state, *args)
        self._barrier()

    def state_dict(self) -> dict:
        """The training state in the reference's agent-save layout, with
        whole tensors (`gather_state`: under a model axis every rank calls
        it).  The tensors that are not split are the live ones: clone them
        to keep a copy."""
        tr = self.trainer
        step = tr.optimizer.steps
        state = {"vln_bert": {"epoch": step,
                              "state_dict": gather_state(tr.model),
                              "optimizer": gather_state(tr.optimizer)}}
        if getattr(tr, "critic", None) is not None:
            state["critic"] = {"epoch": step,
                               "state_dict": gather_state(tr.critic),
                               "optimizer": gather_state(tr.critic_optimizer)}
        return state

    def load_state_dict(self, state: dict) -> None:
        """Restore `state_dict()`'s output in place, each split tensor cut
        to this rank's slice: the optimizers keep their references to the
        modules' parameters."""
        tr = self.trainer
        load_sharded(tr.model, state["vln_bert"]["state_dict"])
        load_sharded(tr.optimizer, state["vln_bert"]["optimizer"])
        if "critic" in state:
            load_sharded(tr.critic, state["critic"]["state_dict"])
            load_sharded(tr.critic_optimizer, state["critic"]["optimizer"])

    def load_checkpoint(self, name: str) -> dict:
        """Restore the slot `name` (or a checkpoint path) into the trainer;
        refuses a checkpoint of a differently configured model."""
        self._barrier()  # rank 0 has written it
        state = self.ckpt.load(name, self.state_dict(),
                               map_location=self.device)
        self.load_state_dict(state)
        self._replicate()
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
        load_sharded(model, {k: sd[k] for k in want})
        critic = getattr(self.trainer, "critic", None)
        if loaded.get("critic_state_dict") and critic is not None:
            load_sharded(critic, loaded["critic_state_dict"])
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
            flax_from_state_dict(gather_state(model), agent),
            flax_from_state_dict(loaded["state_dict"], agent))
        if transferred == 0:
            raise ValueError(f"no parameter subtree of '{path}' matched the "
                             f"{agent} fine-tune model")
        load_sharded(model, state_dict_from_flax(new_params, agent))
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
            flax_from_state_dict(gather_state(model), agent),
            flax_from_state_dict(snapshot, f"{agent}_pretrain"))
        if transferred == 0:
            raise ValueError(f"no parameter subtree of '{path}' matched the "
                             f"{agent} fine-tune model")
        load_sharded(model, state_dict_from_flax(new_params, agent))
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
            ep1 = _take(split.episodes, self._rows(sampler.next_batch()))
            ep2 = _take(split.episodes, self._rows(sampler.next_batch()))
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
        mine = slice(0, bs)  # this rank's rows of each batch
        if self.shard is not None:
            # keep the batch shardable over the data axis
            w = self.shard.size
            bs = max(bs // w * w, w)
            m = bs // w
            mine = slice(self.shard.rank * m, (self.shard.rank + 1) * m)
        # every fresh item's results, by its place in the sequential order
        items = []
        # length bucketing: the early-exit loop runs every batch to its
        # SLOWEST episode, so grouping episodes by expected length (gt path
        # length as the proxy) cuts the steps wasted on already-ended items.
        # Pure scheduling: each item's rollout is independent of its
        # batchmates (ended items are frozen), so per-item results are
        # identical to sequential order.
        gt_path = np.asarray(split.episodes.gt_path)
        gt_len = np.asarray(split.episodes.gt_len)
        scan = np.asarray(split.episodes.scan)
        perm = (np.argsort(gt_len, kind="stable").astype(np.int64) if n > bs
                else np.arange(n, dtype=np.int64))
        # one call a batch, its outputs read before the next call (the
        # port's eval step waits for the device once a step for its early
        # exit, so a call returns with its work done)
        for batch, (pos, fresh) in enumerate(EvalSampler(n, bs)):
            idxs, fresh = perm[pos][mine], fresh[mine]
            out = self._eval_step(_take(split.episodes, idxs))
            self.eval_step_counts.append(self._eval_step.steps)
            if self._eval_detailed:
                det_nodes, det_scores, det_valid = (x.cpu().numpy()
                                                    for x in out[-1])
                out = out[:-1]
            pn, pl = out[0].cpu().numpy(), out[1].cpu().numpy()
            po = out[2].cpu().numpy() if len(out) > 2 else None
            for j, keep in enumerate(fresh):
                if not keep:
                    continue
                items.append({
                    "pos": (batch, mine.start + j), "b": idxs[j],
                    "path": list(pn[j, :pl[j]]),
                    "extra": None if po is None else int(po[j]),
                    "detail": None if not self._eval_detailed else {
                        int(n): float(s) for n, s, v in zip(
                            det_nodes[j], det_scores[j], det_valid[j]) if v}})
        if self.shard is not None:
            items = sorted(merge_results(
                all_gather_objects(items, self.shard.group), key="pos"),
                key=lambda it: it["pos"])
        paths, gts, scans, kept_ids, kept_idx = [], [], [], [], []
        extra = []  # pred_obj (reverie/soon) or declared midstop (r2r_back)
        details = []  # per item {node: stop probability} (detailed_output)
        for it in items:
            b = it["b"]
            paths.append(it["path"])
            gts.append(list(gt_path[b][:int(gt_len[b])]))
            scans.append(int(scan[b]))
            kept_ids.append(split.instr_ids[b] if split.instr_ids else b)
            kept_idx.append(b)
            if it["extra"] is not None:
                extra.append(it["extra"])
            if it["detail"] is not None:
                details.append(it["detail"])
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
        if write_outputs and self.writes:
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
        chrome trace for TensorBoard or Perfetto.  Spans are on
        (utils/spans.py), so the trace shows the program's phases
        (`train.step`, `rollout.step`, `env.*`, `map.*`, `model.*`, ...)
        above the operations they launched."""
        from torch.profiler import (
            ProfilerActivity,
            profile,
            tensorboard_trace_handler,
        )

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        try:
            with spans.on(), profile(
                    activities=acts,
                    on_trace_ready=tensorboard_trace_handler(profile_dir)):
                return self.train_interval(interval)
        finally:
            spans.take()  # the trace holds them; the records are not kept

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
        self._save("save_latest")
        start = time.time()
        failures = 0
        # profiling: VLN_PROFILE_DIR=<dir> traces the first interval, with
        # the program's spans on
        profile_dir = os.environ.get("VLN_PROFILE_DIR")
        for idx in range(0, iters, log_every):
            interval = min(log_every, iters - idx)
            it = idx + interval
            error = None
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
            except Exception as e:  # noqa: BLE001 - deliberate recovery scope
                error = e
            if self.mesh is not None:
                # a fault on any rank is a fault on every rank, so that the
                # ranks roll back together
                flag = torch.tensor(float(error is not None),
                                    device=self.device)
                torch.distributed.all_reduce(flag)
                if flag.item() > 0 and error is None:
                    error = RuntimeError("another rank's interval failed")
            if error is not None:
                failures += 1
                self._record(
                    f"[failure {failures}/{max_failures}] interval at iter "
                    f"{idx} failed: {type(error).__name__}: {error}")
                if failures > max_failures:
                    raise error
                try:
                    self.load_checkpoint("latest_dict")
                    self._record("rolled back to latest_dict")
                except Exception:
                    self._record("no checkpoint to roll back to; continuing "
                                 "with the in-memory state")
                continue
            failures = 0
            if self.writer is not None:
                self.writer.add_scalars(train_metrics, it, prefix="loss")
            loss_str = f"iter {it}"
            for split in self.val_splits:
                score = self.validate(split)
                if self.writer is not None:
                    self.writer.add_scalars(score, it, prefix=split.name)
                loss_str += f", {split.name} " + ", ".join(
                    f"{k}: {v:.2f}" for k, v in score.items())
                if split.name.startswith("val_unseen"):
                    if it % 2000 == 0:
                        self._save("save_snapshot", it, score["sr"],
                                   score["spl"], split.name)
                    self._save("maybe_save_best", split.name, score)
            self._save("save_latest")
            self._record(
                f"[{time.time() - start:.0f}s] {loss_str} | "
                + ", ".join(f"{k}={v:.4f}" for k, v in train_metrics.items()))
        return self.state_dict()
