"""Task-mixing pre-training loop.

The port of `vln_imagine_tpu/pretrain/trainer.py` (a rebuild of
VLN-HAMT/pretrain_src/main_r2r.py:40-530): a multinomial task draw
(`MetaSampler`), the task's batch and forward / loss, gradient
accumulation, the warm-up-linear lr with clip 5.0 (train/optim.py:
`pretrain_optimizer`) and per-task validation on held-out splits.

The model holds the weights and the optimizer the moments; `PretrainState`
carries the step, which counts micro-steps (one per drawn batch), while the
budget of a run counts updates, as the JAX package's `optax.MultiSteps`
does: with `gradient_accumulation_steps` k each update applies the mean of
k micro-step gradients, and the k - 1 calls between updates leave the
parameters as they are.  The draws (tasks, batch indices, labels) are the
JAX package's numpy draws for the same seed; `init_state` makes the same
size-2 probe draws the JAX one makes for its init, so both packages read
one batch stream.  Dropout comes from an `Rng` seeded from the pre-training
seed.  Everything runs on the card unless the caller names a device.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from vln_imagine_tpu_torch.config import Config
from vln_imagine_tpu_torch.envx.tables import EpisodeBatch, WorldTables
from vln_imagine_tpu_torch.ops.dropout import Rng
from vln_imagine_tpu_torch.platform import resolve_device
from vln_imagine_tpu_torch.pretrain.data import (
    E2EImageBatcher,
    MetaSampler,
    PrefetchTrajectoryBatcher,
    TrajectoryBatcher,
)
from vln_imagine_tpu_torch.pretrain.duet_data import (
    DuetTrajectoryBatcher,
    PrefetchDuetTrajectoryBatcher,
)
from vln_imagine_tpu_torch.pretrain.duet_model import DuetPretrainModel
from vln_imagine_tpu_torch.pretrain.hamt_model import HamtPretrainModel
from vln_imagine_tpu_torch.train.optim import pretrain_optimizer


@dataclass
class PretrainState:
    step: int  # micro-steps taken


TASK_ARGS = {
    "mlm": ("txt_ids", "txt_masks", "hist_img_fts", "hist_ang_fts",
            "hist_pano_img_fts", "hist_pano_ang_fts", "hist_masks",
            "txt_labels"),
    "sap": ("txt_ids", "txt_masks", "hist_img_fts", "hist_ang_fts",
            "hist_pano_img_fts", "hist_pano_ang_fts", "hist_masks",
            "ob_img_fts", "ob_ang_fts", "ob_nav_types", "ob_masks",
            "ob_action_viewindex"),
    "sar": ("txt_ids", "txt_masks", "hist_img_fts", "hist_ang_fts",
            "hist_pano_img_fts", "hist_pano_ang_fts", "hist_masks",
            "ob_img_fts", "ob_ang_fts", "ob_nav_types", "ob_masks",
            "ob_action_angles", "ob_progress"),
    "sprel": ("txt_ids", "txt_masks", "hist_img_fts", "hist_ang_fts",
              "hist_pano_img_fts", "hist_pano_ang_fts", "hist_masks",
              "ob_img_fts", "ob_ang_fts", "ob_nav_types", "ob_masks",
              "sp_anchor_idxs", "sp_targets"),
    "mrc": ("txt_ids", "txt_masks", "hist_img_fts", "hist_ang_fts",
            "hist_pano_img_fts", "hist_pano_ang_fts", "hist_masks",
            "hist_mrc_masks", "hist_img_probs"),
    "itm": ("txt_ids", "txt_masks", "hist_img_fts", "hist_ang_fts",
            "hist_pano_img_fts", "hist_pano_ang_fts", "hist_masks",
            "neg_idxs", "shuffled_pos_ids"),
}

# E2E raw-image variants: the same layouts, pixels in place of features
_E2E_RENAME = {"hist_img_fts": "hist_images",
               "hist_pano_img_fts": "hist_pano_images",
               "ob_img_fts": "ob_images"}
E2E_TASK_ARGS = {task: tuple(_E2E_RENAME.get(k, k) for k in args)
                 for task, args in TASK_ARGS.items()}


DUET_TASK_ARGS = {
    "mlm": ("txt_ids", "txt_masks", "txt_labels", "traj_img", "traj_loc",
            "traj_nav", "traj_valid", "agg", "gmap_step_ids", "gmap_pos_fts",
            "gmap_valid", "vp_pos_fts", "vp_valid"),
    "mrc": ("txt_ids", "txt_masks", "traj_img", "traj_loc", "traj_nav",
            "traj_valid", "agg", "gmap_step_ids", "gmap_pos_fts",
            "gmap_valid", "gmap_pair_dists", "vp_pos_fts", "vp_valid",
            "vp_view_mrc_masks", "vp_view_probs"),
    "sap": ("txt_ids", "txt_masks", "traj_img", "traj_loc", "traj_nav",
            "traj_valid", "agg", "gmap_step_ids", "gmap_pos_fts",
            "gmap_valid", "gmap_pair_dists", "gmap_visited", "vp_pos_fts",
            "vp_valid", "vp_nav_valid", "cand_to_gmap", "global_act_labels",
            "local_act_labels"),
    "og": ("txt_ids", "txt_masks", "traj_img", "traj_loc", "traj_nav",
           "traj_valid", "agg", "gmap_step_ids", "gmap_pos_fts",
           "gmap_valid", "gmap_pair_dists", "vp_pos_fts", "vp_valid",
           "vp_obj_valid", "obj_labels"),
}


class BasePretrainer:
    task_args: dict[str, tuple]

    def __init__(self, cfg: Config, model: torch.nn.Module, device=None,
                 seed: int | None = None):
        from vln_imagine_tpu_torch.train.trainer import init_params

        pcfg = cfg.pretrain
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = pcfg.seed if seed is None else seed
        self.sampler = MetaSampler(pcfg.tasks, pcfg.mix_ratio, pcfg.seed)
        init_params(model, torch.Generator().manual_seed(pcfg.seed))
        self.model = model.to(self.device)
        self.optimizer = pretrain_optimizer(
            self.model, pcfg.lr, pcfg.warmup_steps, pcfg.num_train_steps,
            max_grad_norm=pcfg.max_grad_norm)
        self.accum = max(pcfg.gradient_accumulation_steps, 1)
        self.rng = Rng(pcfg.seed, self.device)
        # named held-out splits for validate() (main_r2r.py:303-316
        # validates seen and unseen every valid_steps)
        self.val_batchers: dict[str, Any] = {}

    def init_state(self) -> PretrainState:
        """A fresh run's state.  Draws one size-2 batch of each task, as
        the JAX package's init does, so the two read one batch stream."""
        for t in self.cfg.pretrain.tasks:
            self.batcher.task_batch(t, 2)
        return PretrainState(step=0)

    def _args(self, task: str, batch: dict) -> list[torch.Tensor]:
        return [torch.as_tensor(np.asarray(batch[k])).to(self.device)
                for k in self.task_args[task]]

    def _forward(self, task: str, args, rng):
        return getattr(self.model, f"forward_{task}")(*args, rng=rng)

    def train_step(self, state: PretrainState, task: str, batch: dict
                   ) -> tuple[PretrainState, dict]:
        """One micro-step of `task` on `batch`; every `accum`-th call
        applies the mean gradient.  The metrics stay on the device."""
        loss_sum, n, correct = self._forward(task, self._args(task, batch),
                                             self.rng)
        loss = loss_sum / max(n, 1) if isinstance(n, int) \
            else loss_sum / n.clamp(min=1)
        loss.backward()
        if (state.step + 1) % self.accum == 0:
            if self.accum > 1:
                for p in self.model.parameters():
                    if p.grad is not None:
                        p.grad.div_(self.accum)
            self.optimizer.step()
            self.optimizer.zero_grad()
        return PretrainState(state.step + 1), {
            "loss": loss.detach(), "n": n, "correct": correct}

    # ------------------------------------------------------------------ api
    def train(self, state: PretrainState, num_steps: int,
              batch_size: int | None = None, log_every: int = 0,
              log_fn=print) -> tuple[PretrainState, dict]:
        bsz = batch_size or self.cfg.pretrain.batch_size
        stats: dict[str, list] = {}
        t0 = time.time()
        examples = 0
        for i in range(num_steps):
            task = self.sampler.draw()
            batch = self.batcher.task_batch(task, bsz)
            state, metrics = self.train_step(state, task, batch)
            stats.setdefault(task, []).append(metrics["loss"])
            examples += bsz
            if log_every and (i + 1) % log_every == 0:
                means = {t: round(float(torch.stack(v).mean()), 4)
                         for t, v in stats.items()}
                log_fn(f"step {state.step}: {means}  "
                       f"({examples / (time.time() - t0):.1f} ex/s)")
        summary = {t: float(torch.stack(v).mean()) for t, v in stats.items()}
        return state, summary

    def add_validation_split(self, name: str, world: WorldTables,
                             ep: EpisodeBatch, seed: int = 0) -> None:
        """Register a held-out split (e.g. 'val_seen' / 'val_unseen') for
        validate() (main_r2r.py:160-188,303-316)."""
        self.val_batchers[name] = self._make_batcher(world, ep, seed)

    @torch.no_grad()
    def validate(self, state: PretrainState, batch_size: int = 8,
                 num_batches: int = 4, split: str | None = None) -> dict:
        """Per-task loss / accuracy with dropout off on the named held-out
        split, or the first registered one, or with none registered the
        training batcher (a smoke run only)."""
        if split is not None:
            batcher = self.val_batchers[split]
        elif self.val_batchers:
            batcher = next(iter(self.val_batchers.values()))
        else:
            batcher = self.batcher
        out = {}
        for task in self.cfg.pretrain.tasks:
            tot = torch.zeros(3, dtype=torch.float64)
            for _ in range(num_batches):
                batch = batcher.task_batch(task, batch_size)
                loss_sum, n, correct = self._forward(
                    task, self._args(task, batch), None)
                tot += torch.tensor([float(loss_sum), float(n),
                                     float(correct)], dtype=torch.float64)
            n = max(float(tot[1]), 1.0)
            out[task] = {"loss": float(tot[0]) / n,
                         "acc": float(tot[2]) / n}
        return out

    def save(self, state: PretrainState, log_dir: str) -> str:
        """`model_step_<N>` (the model's state_dict with the reference's key
        names, the file ModelSaver writes, pretrain_src/utils/save.py:23-46)
        and `train_state_<N>` (step and optimizer) in `log_dir`."""
        import os

        path = os.path.join(log_dir, f"model_step_{state.step}")
        torch.save(self.model.state_dict(), path)
        torch.save({"step": state.step,
                    "optimizer": self.optimizer.state_dict()},
                   os.path.join(log_dir, f"train_state_{state.step}"))
        return path

    def resume(self, path: str) -> PretrainState:
        """Load a `model_step_<N>` snapshot and its `train_state_<N>`."""
        import os

        self.model.load_state_dict(torch.load(path, map_location=self.device,
                                              weights_only=True))
        head, name = os.path.split(path)
        ts = torch.load(os.path.join(head, name.replace("model_step_",
                                                        "train_state_")),
                        map_location=self.device, weights_only=True)
        self.optimizer.load_state_dict(ts["optimizer"])
        return PretrainState(int(ts["step"]))


class HamtPretrainer(BasePretrainer):
    """HAMT six-task pre-training on view features; with `feature_bank`
    (a native FeatureBank of [V * Df] rows, scan * N + node) the batcher
    reads the features through the asynchronous prefetcher."""

    task_args = TASK_ARGS

    def __init__(self, cfg: Config, world: WorldTables, ep: EpisodeBatch,
                 image_prob_size: int = 64, seed: int | None = None,
                 feature_bank=None, device=None):
        model = HamtPretrainModel(cfg.model, image_prob_size=image_prob_size,
                                  tasks=tuple(cfg.pretrain.tasks))
        super().__init__(cfg, model, device, seed)
        self._image_prob_size = image_prob_size
        self._feature_bank = feature_bank
        self.batcher = self._make_batcher(world, ep, self.seed)

    def _make_batcher(self, world: WorldTables, ep: EpisodeBatch, seed: int):
        kw = dict(max_hist_len=self.cfg.env.max_action_len,
                  angle_feat_size=self.cfg.model.angle_feat_size,
                  image_prob_size=self._image_prob_size,
                  vocab_size=self.cfg.model.vocab_size, seed=seed,
                  mlm_prob=self.cfg.pretrain.mlm_prob,
                  mrc_prob=self.cfg.pretrain.mrc_prob)
        if self._feature_bank is not None:
            return PrefetchTrajectoryBatcher(world, ep, self._feature_bank,
                                             **kw)
        return TrajectoryBatcher(world, ep, **kw)


class DuetPretrainer(BasePretrainer):
    """DUET pre-training (VLN-DUET/pretrain_src/train_r2r.py:39-457,
    config/r2r_pretrain.json: mlm / mrc / sap 1:1:1; og on REVERIE /
    SOON).  The model carries the language-side x-layer blocks under MLM
    (`use_lang2visn_attn`, pretrain config/r2r_model_config.json:32); with
    `feature_bank` the batcher reads the features through the asynchronous
    prefetcher (the reference's PrefetchLoader covers both stacks,
    pretrain_src/data/loader.py:90)."""

    task_args = DUET_TASK_ARGS

    def __init__(self, cfg: Config, world: WorldTables, ep: EpisodeBatch,
                 image_prob_size: int = 64, seed: int | None = None,
                 feature_bank=None, device=None):
        mcfg = dataclasses.replace(cfg.model, use_lang2visn_attn=True)
        model = DuetPretrainModel(mcfg, image_prob_size=image_prob_size,
                                  tasks=tuple(cfg.pretrain.tasks))
        super().__init__(cfg, model, device, seed)
        self._image_prob_size = image_prob_size
        self._feature_bank = feature_bank
        self.batcher = self._make_batcher(world, ep, self.seed)

    def _make_batcher(self, world: WorldTables, ep: EpisodeBatch, seed: int):
        kw = dict(max_hist_len=self.cfg.env.max_action_len,
                  max_gmap_nodes=self.cfg.env.max_gmap_nodes,
                  angle_feat_size=self.cfg.model.angle_feat_size,
                  image_prob_size=self._image_prob_size,
                  vocab_size=self.cfg.model.vocab_size, seed=seed,
                  mlm_prob=self.cfg.pretrain.mlm_prob)
        if self._feature_bank is not None:
            return PrefetchDuetTrajectoryBatcher(world, ep,
                                                 self._feature_bank, **kw)
        return DuetTrajectoryBatcher(world, ep, **kw)


class E2EPretrainer(BasePretrainer):
    """Six-task E2E image pre-training with the ViT in the loop
    (VLN-HAMT/pretrain_src/main_r2r_image.py + data/image_tasks.py): the
    batches carry raw panorama pixels from a RawPanoramaBank (or any
    [S, N, V, h, w, 3]-indexable array)."""

    task_args = E2E_TASK_ARGS

    def __init__(self, cfg: Config, world: WorldTables, ep: EpisodeBatch,
                 images, vit_config=None, image_prob_size: int = 64,
                 seed: int | None = None, device=None):
        from vln_imagine_tpu_torch.pretrain.hamt_e2e import (
            HamtE2EPretrainModel,
        )

        model = HamtE2EPretrainModel(cfg.model, vit_config=vit_config,
                                     image_prob_size=image_prob_size,
                                     tasks=tuple(cfg.pretrain.tasks))
        super().__init__(cfg, model, device, seed)
        self._image_prob_size = image_prob_size
        self._images = images
        self.batcher = self._make_batcher(world, ep, self.seed)

    def _make_batcher(self, world: WorldTables, ep: EpisodeBatch, seed: int):
        return E2EImageBatcher(
            world, ep, self._images, max_hist_len=self.cfg.env.max_action_len,
            angle_feat_size=self.cfg.model.angle_feat_size,
            image_prob_size=self._image_prob_size,
            vocab_size=self.cfg.model.vocab_size, seed=seed,
            mlm_prob=self.cfg.pretrain.mlm_prob,
            mrc_prob=self.cfg.pretrain.mrc_prob)
