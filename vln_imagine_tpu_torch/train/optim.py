"""Optimizers of the HAMT train step: global-norm clipping, then Adam over
parameter groups with step-indexed learning rates.

The port of `vln_imagine_tpu/train/optim.py` for the released recipe.  The
reference builds a 3-group torch optimizer over {contrastive alignment
model, imagine embeddings, everything else} (agent_cmt.py:82-101) and
mutates group learning rates / requires_grad per training stage in its
training script (main.py:200-278):

  stage1 (idx < 0.25*iters):  aux groups lr*10, trainable; rest frozen
  stage2 (0.25 - 0.5*iters):  aux groups lr*5;  rest lr*0.1
  stage3 (>= 0.5*iters):      every group lr*0.1

The JAX package expresses this as optax transforms, and the port follows
its arithmetic, update order and state semantics exactly:

- `clip_by_global_norm(max_norm)` first, over every model gradient;
- per group, optax's `scale_by_adam(eps=1e-8)` (bias-corrected moments,
  m_hat / (sqrt(v_hat) + eps)), then weight decay if any, then
  `-lr(count)`; parameters move by p + u;
- the "rest" group sits inside `freeze_until(stage1_end)`: before that step
  it gets no update, no moment update and no count.  Its inner count (and
  so its schedule) therefore starts at 0 when it unfreezes and lags the
  outer step by stage1_end steps: the rest group runs at 1.0x the base lr
  for the first stage1_end steps of stage 2, where the reference has 0.1x.
  This is a defect of the JAX package that the port reproduces on purpose
  (ROADMAP Queue 3), so that the two stay comparable.

RAdam, Ralamb, RangerLars and Lookahead are not in the released recipe and
are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

def label_hamt_param(name: str) -> str:
    """Warm-up group of a HamtModel (or DuetModel: the aux keys are the
    same) parameter by its top-level module, as the JAX package's
    `label_hamt_params`."""
    if name.startswith("contrastive_alignment_model.image_proj."):
        return "contrastive"
    if name.startswith("imagine_embeddings."):
        return "imagine"
    return "rest"


def staged_schedule(stage1_end: int, stage2_end: int, base_lr: float,
                    stage_lrs: tuple[float, float, float]) -> Callable[[int], float]:
    s1, s2, s3 = stage_lrs

    def schedule(count: int) -> float:
        return base_lr * (s1 if count < stage1_end
                          else s2 if count < stage2_end else s3)

    return schedule


class AdamGroup:
    """optax `scale_by_adam` -> `add_decayed_weights` -> `scale_by_schedule`
    over a list of parameters, active from `unfreeze_step` on (optax
    `freeze_until`).  Moments are created at a parameter's first gradient:
    a parameter that never had one has zero moments, for which Adam's update
    is exactly zero, so it is skipped.  `state` keys the moments by the
    parameter's index in `params`, so that they can be saved."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax defaults; the JAX package sets eps

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr: Callable[[int], float], weight_decay: float = 0.0,
                 unfreeze_step: int = 0):
        self.params = list(params)
        self.lr, self.weight_decay = lr, weight_decay
        self.unfreeze_step = unfreeze_step
        self.count = 0  # the inner Adam / schedule count
        self.state: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    @torch.no_grad()
    def step(self, outer_step: int,
             scale: Callable[[torch.Tensor], torch.Tensor] | None) -> None:
        """One update from `p.grad`, each gradient first multiplied by the
        clip factor `scale` (None: no clipping)."""
        if outer_step < self.unfreeze_step or not self.params:
            return
        count = self.count + 1
        dev = self.params[0].device
        bc1 = (1.0 - torch.tensor(self.b1) ** count).to(dev)  # f32, as optax
        bc2 = (1.0 - torch.tensor(self.b2) ** count).to(dev)
        step_size = -self.lr(self.count)
        for i, p in enumerate(self.params):
            g = p.grad
            if g is None and i not in self.state:
                continue
            if g is None:
                g = torch.zeros_like(p)
            elif scale is not None:
                g = scale(g)
            mu, nu = self.state.get(i) or (torch.zeros_like(p),
                                           torch.zeros_like(p))
            mu = (1 - self.b1) * g + self.b1 * mu
            nu = (1 - self.b2) * (g * g) + self.b2 * nu
            self.state[i] = (mu, nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u * step_size)
        self.count = count

    def state_dict(self) -> dict:
        """The count and the moments by parameter index; a parameter that
        never had a gradient has no entry."""
        return {"count": self.count,
                "mu": {i: mu for i, (mu, _) in self.state.items()},
                "nu": {i: nu for i, (_, nu) in self.state.items()}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore `state_dict()`'s output: moments present here are
        overwritten in place, moments absent from `state` are dropped (so
        the parameter stays without one), and the rest are created on the
        parameter's device."""
        if set(state["mu"]) != set(state["nu"]) or not all(
                0 <= i < len(self.params) for i in state["mu"]):
            raise ValueError("optimizer state does not match this group's "
                             f"{len(self.params)} parameters")
        for i in list(self.state):
            if i not in state["mu"]:
                del self.state[i]
        for i, mu in state["mu"].items():
            p, nu = self.params[i], state["nu"][i]
            if mu.shape != p.shape or nu.shape != p.shape:
                raise ValueError(f"moment {i} has shape {tuple(mu.shape)}, "
                                 f"its parameter {tuple(p.shape)}")
            if i in self.state:
                self.state[i][0].copy_(mu)
                self.state[i][1].copy_(nu)
            else:
                self.state[i] = (mu.to(p.device, torch.float32, copy=True),
                                 nu.to(p.device, torch.float32, copy=True))
        self.count = int(state["count"])


def global_norm(params: list[torch.nn.Parameter]) -> torch.Tensor:
    """optax.global_norm of the gradients: sqrt of the sum of their squares
    (a missing gradient counts as zero)."""
    total = torch.zeros((), device=params[0].device)
    for p in params:
        if p.grad is not None:
            total = total + torch.sum(p.grad * p.grad)
    return torch.sqrt(total)


class GroupedOptimizer:
    """clip_by_global_norm(max_grad_norm) (None: no clip) -> one AdamGroup
    per label.  `step()` reads `p.grad` and returns the gradient's global
    norm before the clip, as a device tensor (no host sync)."""

    def __init__(self, groups: list[AdamGroup],
                 max_grad_norm: float | None = None):
        self.groups = groups
        self.max_grad_norm = max_grad_norm
        self.steps = 0

    def params(self):
        return [p for g in self.groups for p in g.params]

    def state_dict(self) -> dict:
        return {"steps": self.steps,
                "groups": [g.state_dict() for g in self.groups]}

    def load_state_dict(self, state: dict) -> None:
        """Restore `state_dict()`'s output in place (the groups keep their
        parameters)."""
        if len(state["groups"]) != len(self.groups):
            raise ValueError(f"optimizer state has {len(state['groups'])} "
                             f"groups, this optimizer {len(self.groups)}")
        for group, g_state in zip(self.groups, state["groups"]):
            group.load_state_dict(g_state)
        self.steps = int(state["steps"])

    def zero_grad(self) -> None:
        for p in self.params():
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        norm = global_norm(self.params())
        scale = None
        if self.max_grad_norm:
            trigger = norm < self.max_grad_norm
            max_norm = self.max_grad_norm

            def scale(g):  # optax: select(trigger, g, g / norm * max_norm)
                return torch.where(trigger, g, g / norm * max_norm)
        for group in self.groups:
            group.step(self.steps, scale)
        self.steps += 1
        return norm


def _check_optim(optim: str) -> None:
    if optim not in ("adam", "adamw"):
        raise NotImplementedError(f"optimizer {optim!r} is not ported yet "
                                  "(adam / adamw only)")


def warmup_variant4_optimizer(named_params, base_lr: float, total_iters: int,
                              optim: str = "adamw", max_grad_norm: float = 40.0,
                              stage1_iters: int = -1, stage2_iters: int = -1,
                              weight_decay: float = 0.0) -> GroupedOptimizer:
    """The 3-stage, 3-group schedule over `named_params` of a HamtModel.
    stage1_iters / stage2_iters are the stage END boundaries; -1 gives the
    reference's 0.25*iters / 0.5*iters (main.py:230,244)."""
    _check_optim(optim)
    stage1_end = stage1_iters if stage1_iters >= 0 else int(0.25 * total_iters)
    stage2_end = stage2_iters if stage2_iters >= 0 else int(0.5 * total_iters)
    if stage1_end > stage2_end:
        raise ValueError(f"stage ends {stage1_end} > {stage2_end}")
    aux = staged_schedule(stage1_end, stage2_end, base_lr, (10.0, 5.0, 0.1))
    rest = staged_schedule(stage1_end, stage2_end, base_lr, (1.0, 0.1, 0.1))
    by_label: dict[str, list] = {"contrastive": [], "imagine": [], "rest": []}
    for name, p in named_params:
        by_label[label_hamt_param(name)].append(p)
    return GroupedOptimizer([
        AdamGroup(by_label["contrastive"], aux, weight_decay),
        AdamGroup(by_label["imagine"], aux, weight_decay),
        AdamGroup(by_label["rest"], rest, weight_decay,
                  unfreeze_step=stage1_end),
    ], max_grad_norm)


def plain_optimizer(params, base_lr: float, optim: str = "adamw",
                    max_grad_norm: float | None = 40.0,
                    weight_decay: float = 0.0) -> GroupedOptimizer:
    """(clip ->) Adam at a constant lr over `params`."""
    _check_optim(optim)
    return GroupedOptimizer(
        [AdamGroup(params, lambda count: base_lr, weight_decay)],
        max_grad_norm)
