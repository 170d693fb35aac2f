"""HAMT trainer: model and critic construction, seeded init, greedy eval and
the IL + RL update step.

The port of `vln_imagine_tpu/train/trainer.py:HamtTrainer`.  The modules
hold their parameters and the optimizers their state, so the eval step takes
only the episodes and the train step only the two episode batches.

One train step is one reference iteration (agent_cmt.py:799-832): under
'sample' feedback an IL rollout (teacher forcing, weight ml_weight) and an
RL rollout (sampled actions, A2C) share one backward, or with
`fused_sample_rollout` one rollout of both batches side by side ('mixed'
feedback, the same losses per half); under 'teacher' only the IL rollout
runs.  The navigator and the critic each have their own optimizer
(train/optim.py, any of `cfg.train.optim`): the navigator's clips at 40 and
carries the 3-stage imagination warm-up, the critic's does neither.

The eval step returns a third element for the tasks that score one: the
grounded object (REVERIE / SOON) or the declared midstop (r2r_back).

Under `e2e_imagination` the model holds the imagination ViT
(models/vit.py): 'frozen' keeps it out of the optimizer, 'trainable' trains
it with the rest of the navigator.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from vln_imagine_tpu_torch.config import Config
from vln_imagine_tpu_torch.envx.tables import EpisodeBatch, WorldTables
from vln_imagine_tpu_torch.models.bert import (
    Critic,
    LayerNormF32,
    PackedSelfAttention,
)
from vln_imagine_tpu_torch.models.hamt import HamtModel
from vln_imagine_tpu_torch.ops.dropout import Rng
from vln_imagine_tpu_torch.platform import resolve_device
from vln_imagine_tpu_torch.train.optim import (
    plain_optimizer,
    warmup_variant4_optimizer,
)
from vln_imagine_tpu_torch.train.rollout_hamt import make_eval_fn, rollout_hamt

# flax's lecun_normal: a normal truncated at +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers, drawn from `generator` in module order:
    Dense and Conv kernels lecun_normal (the packed q/k/v projection of
    DUET's pano encoder too), biases 0, embeddings N(0, 1/dim), LayerNorm 1
    and 0, the [CLS] tokens 0, the ViT's position embeddings N(0, 0.02)."""
    def lecun_normal(weight):
        std = 1.0 / math.sqrt(weight[0].numel()) / _TRUNC_STD
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            lecun_normal(mod.weight)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, PackedSelfAttention):
            lecun_normal(mod.in_proj_weight)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.embedding_dim),
                               generator=generator)
        elif isinstance(mod, LayerNormF32):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith("cls_token"):
            p.zero_()
        elif name.endswith("pos_embed"):
            p.normal_(0.0, 0.02, generator=generator)


def model_optimizer(cfg: Config, model: nn.Module):
    """The navigator's optimizer: the 3-stage imagination warm-up when the
    recipe asks for it (variant4 with the cosine alignment on), else plain
    Adam; both clip at `max_grad_norm`.  A 'frozen' e2e ViT is in no group
    (the JAX package's `freeze_module`: no update, so no weight decay
    either); a 'trainable' one falls in the warm-up's "rest" group."""
    tcfg, mcfg = cfg.train, cfg.model
    named = [(n, p) for n, p in model.named_parameters()
             if not (mcfg.e2e_imagination == "frozen"
                     and n.startswith("imagine_vit."))]
    if (tcfg.experimental_warmup and tcfg.experimental_warmup_type == "variant4"
            and mcfg.imagine_enc_pano and mcfg.use_cosine_aux_loss):
        return warmup_variant4_optimizer(
            named, tcfg.lr, tcfg.iters, tcfg.optim,
            tcfg.max_grad_norm, stage1_iters=tcfg.warmup_stage1_iters,
            stage2_iters=tcfg.warmup_stage2_iters,
            weight_decay=tcfg.weight_decay)
    return plain_optimizer([p for _, p in named], tcfg.lr, tcfg.optim,
                           tcfg.max_grad_norm, weight_decay=tcfg.weight_decay)


def concat_episodes(a: EpisodeBatch, b: EpisodeBatch) -> EpisodeBatch:
    """The items of `a`, then those of `b`, as one batch."""
    return dataclasses.replace(a, **{
        f.name: None if getattr(a, f.name) is None
        else torch.cat([getattr(a, f.name), getattr(b, f.name)])
        for f in dataclasses.fields(a)})


class HamtTrainer:
    """Builds the HAMT model and its critic with seeded weights on `device`
    (the card unless the caller names one), their optimizers, the greedy
    eval step and the train step over `tables`.  Every random draw of
    training comes from `self.rng`, seeded from `cfg.train.seed`."""

    def __init__(self, cfg: Config, tables: WorldTables, device=None,
                 seed: int | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        seed = cfg.train.seed if seed is None else seed
        gen = torch.Generator().manual_seed(seed)
        model = HamtModel(cfg.model, feat_dropout=cfg.train.feat_dropout)
        critic = Critic(cfg.model)
        init_params(model, gen)  # on the CPU: the same weights on any device
        init_params(critic, gen)
        self.model = model.to(self.device).eval()
        self.critic = critic.to(self.device)
        self.tables = tables.to(self.device)
        self.rng = Rng(seed, self.device)
        self.optimizer = model_optimizer(cfg, self.model)
        self.critic_optimizer = plain_optimizer(
            self.critic.parameters(), cfg.train.lr, cfg.train.optim,
            max_grad_norm=None)

    def make_eval_step(self):
        """episodes -> (path_nodes, path_len), greedy with early exit, and
        `pred_obj` (objects) or `midstop` (r2r_back) as a third element."""
        return make_eval_fn(self.model, self.tables, self.cfg, self.device)

    def make_train_step(self, feedback: str = "sample"):
        """Returns step(ep_il, ep_rl) -> metrics: one IL (+ RL) update of the
        model and the critic.  The metrics (`loss`, `ml_loss`, `aux_loss`,
        `rl_loss`, `entropy`, `grad_norm` before the clip) come back as
        device tensors; the step itself never waits for the device."""
        cfg, model, critic, tables, rng = (self.cfg, self.model, self.critic,
                                           self.tables, self.rng)
        tcfg = cfg.train
        if feedback not in ("teacher", "sample"):
            raise ValueError(f"feedback {feedback!r}")
        fused = (feedback == "sample" and tcfg.ml_weight != 0
                 and tcfg.fused_sample_rollout)
        # teacher-forced rollouts end with the annotated path, so they need
        # only max_gt_path_len steps; cvdn's shortest-path teacher is not
        # bounded by the annotated length
        t_il = (cfg.env.max_action_len if cfg.dataset == "cvdn"
                else min(cfg.env.max_gt_path_len, cfg.env.max_action_len))
        dev = self.device

        def run(ep, **kw):
            return rollout_hamt(model, tables, ep, cfg, rng=rng, critic=critic,
                                deterministic=False, **kw)

        def step(ep_il: EpisodeBatch, ep_rl: EpisodeBatch) -> dict:
            ep_il, ep_rl = ep_il.to(dev), ep_rl.to(dev)
            self.optimizer.zero_grad()
            self.critic_optimizer.zero_grad()
            zero = torch.zeros((), device=dev)
            metrics = dict(ml_loss=zero, aux_loss=zero, rl_loss=zero,
                           entropy=zero)
            loss = zero
            if feedback == "teacher":
                res = run(ep_il, feedback="teacher",
                          train_ml=tcfg.teacher_weight, max_steps=t_il)
                loss = loss + res.loss
                metrics.update(ml_loss=res.ml_loss, aux_loss=res.aux_loss)
            elif fused:
                # one rollout at batch 2B: the IL half teacher-forced, the RL
                # half sampled, over max_action_len steps
                il_mask = torch.cat([
                    torch.ones(ep_il.batch, dtype=torch.bool, device=dev),
                    torch.zeros(ep_rl.batch, dtype=torch.bool, device=dev)])
                res = run(concat_episodes(ep_il, ep_rl), feedback="mixed",
                          train_ml=tcfg.ml_weight, train_rl=True,
                          il_mask=il_mask)
                loss = loss + res.loss
                metrics.update(ml_loss=res.ml_loss, aux_loss=res.aux_loss,
                               rl_loss=res.rl_loss, entropy=res.entropy_sum)
            else:
                if tcfg.ml_weight != 0:
                    res = run(ep_il, feedback="teacher",
                              train_ml=tcfg.ml_weight, max_steps=t_il)
                    loss = loss + res.loss
                    metrics.update(ml_loss=res.ml_loss, aux_loss=res.aux_loss)
                res = run(ep_rl, feedback="sample", train_rl=True)
                loss = loss + res.loss
                metrics.update(rl_loss=res.rl_loss, entropy=res.entropy_sum)
            loss.backward()
            metrics["grad_norm"] = self.optimizer.step()
            self.critic_optimizer.step()
            metrics["loss"] = loss
            return {k: v.detach() for k, v in metrics.items()}

        return step
