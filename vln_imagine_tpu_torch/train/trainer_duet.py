"""DUET trainer: model construction, seeded init, greedy eval (optionally
with the final stop table) and the update step of each training algorithm.

The port of `vln_imagine_tpu/train/trainer_duet.py:DuetTrainer`.  One train
step is one reference iteration (VLN-DUET/map_nav_src/r2r/agent_base.py:
185-231): train_alg 'imitation' runs one teacher-forced rollout;
'dagger' (the released R2R recipe) runs a teacher-forced rollout weighted
by ml_weight and a rollout of sampled actions ('expl_sample' with
`expl_sample`) supervised by the expert with weight 1, both under one
backward; 'rl' runs the teacher-forced rollout and a sampled A2C rollout
with a critic, which has its own optimizer (the reference declares this
branch and its rollout ignores it; the JAX package makes it work, and so
does the port).  The navigator's optimizer is that of train/trainer.py:
clip at 40 and the 3-stage imagination warm-up, whose groups
(`contrastive_alignment_model.image_proj.*`, `imagine_embeddings.*`, the
rest) the DUET keys share with HAMT.

With objects (REVERIE / SOON) the eval step also returns the grounded
object per item.

Under `e2e_imagination` the model holds the imagination ViT, kept out of
the optimizer when 'frozen' (train/trainer.py:model_optimizer).
"""

from __future__ import annotations

import torch

from vln_imagine_tpu_torch.config import Config
from vln_imagine_tpu_torch.envx.tables import EpisodeBatch, WorldTables
from vln_imagine_tpu_torch.models.bert import Critic
from vln_imagine_tpu_torch.models.duet import DuetModel
from vln_imagine_tpu_torch.ops.dropout import Rng
from vln_imagine_tpu_torch.platform import resolve_device
from vln_imagine_tpu_torch.train.optim import plain_optimizer
from vln_imagine_tpu_torch.train.rollout_duet import make_eval_fn, rollout_duet
from vln_imagine_tpu_torch.train.trainer import init_params, model_optimizer


class DuetTrainer:
    """Builds the DUET model with seeded weights on `device` (the card unless
    the caller names one), its optimizer, under train_alg 'rl' the critic
    and its optimizer (else `critic` is None), the greedy eval step and the
    train step over `tables`.  Every random draw of training comes from
    `self.rng`, seeded from `cfg.train.seed`."""

    def __init__(self, cfg: Config, tables: WorldTables, device=None,
                 seed: int | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        seed = cfg.train.seed if seed is None else seed
        gen = torch.Generator().manual_seed(seed)
        model = DuetModel(cfg.model, feat_dropout=cfg.train.feat_dropout)
        init_params(model, gen)
        self.model = model.to(self.device).eval()
        self.critic = self.critic_optimizer = None
        if cfg.train.train_alg == "rl":
            critic = Critic(cfg.model)
            init_params(critic, gen)
            self.critic = critic.to(self.device)
            self.critic_optimizer = plain_optimizer(
                self.critic.parameters(), cfg.train.lr, cfg.train.optim,
                max_grad_norm=None)
        self.tables = tables.to(self.device)
        self.rng = Rng(seed, self.device)
        self.optimizer = model_optimizer(cfg, self.model)

    def make_eval_step(self, detailed: bool = False):
        """episodes -> (path_nodes, path_len), greedy with early exit; with
        objects then `pred_obj`, and with `detailed` last the final stop
        table (stop_nodes, stop_scores, stop_valid) (--detailed_output,
        agent.py:597-601)."""
        return make_eval_fn(self.model, self.tables, self.cfg, self.device,
                            detailed=detailed)

    def make_train_step(self):
        """Returns step(ep_il, ep_student) -> metrics: one update under
        `cfg.train.train_alg`.  The metrics (`loss`, `ml_loss`, `aux_loss`;
        for 'dagger' `dagger_loss` and `entropy`, for 'rl' `rl_loss` and
        `entropy`; `grad_norm` before the clip) come back as device tensors;
        the step never waits for the device."""
        cfg, model, tables, rng = self.cfg, self.model, self.tables, self.rng
        tcfg = cfg.train
        alg = tcfg.train_alg
        if alg not in ("imitation", "dagger", "rl"):
            raise ValueError(f"train_alg {alg!r}")
        if alg == "rl" and tcfg.gamma == 0.0:
            # the DUET presets inherit gamma=0 from the released dagger
            # config; with it the A2C returns collapse to one-step rewards
            raise ValueError(
                "train_alg='rl' needs a nonzero discount: set "
                "cfg.train.gamma (HAMT uses 0.9)")
        # teacher-forced rollouts end with the annotated path (cvdn's
        # supervision is not bounded by it)
        t_il = (cfg.env.max_action_len if cfg.dataset == "cvdn"
                else min(cfg.env.max_gt_path_len, cfg.env.max_action_len))
        dev = self.device
        student_fb = "expl_sample" if tcfg.expl_sample else "sample"

        def run(ep, **kw):
            return rollout_duet(model, tables, ep, cfg, rng=rng,
                                deterministic=False, **kw)

        def step(ep_il: EpisodeBatch, ep_student: EpisodeBatch) -> dict:
            ep_il, ep_student = ep_il.to(dev), ep_student.to(dev)
            self.optimizer.zero_grad()
            if self.critic is not None:
                self.critic_optimizer.zero_grad()
            zero = torch.zeros((), device=dev)
            metrics = dict(ml_loss=zero, aux_loss=zero)
            loss = zero
            if alg == "imitation" or tcfg.ml_weight != 0:
                res = run(ep_il, feedback="teacher",
                          train_ml=1.0 if alg == "imitation" else tcfg.ml_weight,
                          max_steps=t_il)
                loss = loss + res.loss
                metrics.update(ml_loss=res.ml_loss, aux_loss=res.aux_loss)
            if alg == "dagger":  # agent_base.py:211
                res = run(ep_student, feedback=student_fb, train_ml=1.0)
                loss = loss + res.loss
                metrics.update(dagger_loss=res.ml_loss,
                               entropy=res.entropy_sum)
            elif alg == "rl":
                res = run(ep_student, feedback="sample", critic=self.critic,
                          train_rl=True)
                loss = loss + res.loss
                metrics.update(rl_loss=res.rl_loss, entropy=res.entropy_sum)
            loss.backward()
            metrics["grad_norm"] = self.optimizer.step()
            if self.critic is not None:
                self.critic_optimizer.step()
            metrics["loss"] = loss
            return {k: v.detach() for k, v in metrics.items()}

        return step
