"""DUET trainer: model construction, seeded init, greedy eval and the IL /
DAgger update step.

The port of `vln_imagine_tpu/train/trainer_duet.py:DuetTrainer`.  One train
step is one reference iteration (VLN-DUET/map_nav_src/r2r/agent_base.py:
185-231): train_alg 'imitation' runs one teacher-forced rollout;
'dagger' (the released R2R recipe) runs a teacher-forced rollout weighted
by ml_weight and a rollout of sampled actions supervised by the SPL expert
with weight 1, both under one backward.  The optimizer is the navigator's
of train/trainer.py: clip at 40 and the 3-stage imagination warm-up, whose
groups (`contrastive_alignment_model.image_proj.*`, `imagine_embeddings.*`,
the rest) the DUET keys share with HAMT.

Not ported yet: train_alg 'rl' (DUET's A2C and its critic) and
`expl_sample`.
"""

from __future__ import annotations

import torch

from vln_imagine_tpu_torch.config import Config
from vln_imagine_tpu_torch.envx.tables import EpisodeBatch, WorldTables
from vln_imagine_tpu_torch.models.duet import DuetModel
from vln_imagine_tpu_torch.ops.dropout import Rng
from vln_imagine_tpu_torch.platform import resolve_device
from vln_imagine_tpu_torch.train.rollout_duet import make_eval_fn, rollout_duet
from vln_imagine_tpu_torch.train.trainer import init_params, model_optimizer


class DuetTrainer:
    """Builds the DUET model with seeded weights on `device` (the card unless
    the caller names one), its optimizer, the greedy eval step and the train
    step over `tables`.  Every random draw of training comes from
    `self.rng`, seeded from `cfg.train.seed`."""

    def __init__(self, cfg: Config, tables: WorldTables, device=None,
                 seed: int | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        seed = cfg.train.seed if seed is None else seed
        model = DuetModel(cfg.model, feat_dropout=cfg.train.feat_dropout)
        init_params(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.tables = tables.to(self.device)
        self.rng = Rng(seed, self.device)
        self.optimizer = model_optimizer(cfg, self.model)

    def make_eval_step(self):
        """episodes -> (path_nodes, path_len), greedy with early exit."""
        return make_eval_fn(self.model, self.tables, self.cfg, self.device)

    def make_train_step(self):
        """Returns step(ep_il, ep_student) -> metrics: one update under
        `cfg.train.train_alg`.  The metrics (`loss`, `ml_loss`, `aux_loss`,
        and for 'dagger' `dagger_loss` and `entropy`, `grad_norm` before the
        clip) come back as device tensors; the step never waits for the
        device."""
        cfg, model, tables, rng = self.cfg, self.model, self.tables, self.rng
        tcfg = cfg.train
        alg = tcfg.train_alg
        if alg not in ("imitation", "dagger"):
            raise NotImplementedError(f"train_alg {alg!r} is not ported yet")
        if alg == "dagger" and tcfg.expl_sample:
            raise NotImplementedError("expl_sample is not ported yet")
        # teacher-forced rollouts end with the annotated path
        t_il = min(cfg.env.max_gt_path_len, cfg.env.max_action_len)
        dev = self.device

        def run(ep, **kw):
            return rollout_duet(model, tables, ep, cfg, rng=rng,
                                deterministic=False, **kw)

        def step(ep_il: EpisodeBatch, ep_student: EpisodeBatch) -> dict:
            ep_il, ep_student = ep_il.to(dev), ep_student.to(dev)
            self.optimizer.zero_grad()
            zero = torch.zeros((), device=dev)
            metrics = dict(ml_loss=zero, aux_loss=zero)
            loss = zero
            if alg == "imitation" or tcfg.ml_weight != 0:
                res = run(ep_il, feedback="teacher",
                          train_ml=1.0 if alg == "imitation" else tcfg.ml_weight,
                          max_steps=t_il)
                loss = loss + res.loss
                metrics.update(ml_loss=res.ml_loss, aux_loss=res.aux_loss)
            if alg == "dagger":
                res = run(ep_student, feedback="sample", train_ml=1.0)
                loss = loss + res.loss
                metrics.update(dagger_loss=res.ml_loss,
                               entropy=res.entropy_sum)
            loss.backward()
            metrics["grad_norm"] = self.optimizer.step()
            metrics["loss"] = loss
            return {k: v.detach() for k, v in metrics.items()}

        return step
