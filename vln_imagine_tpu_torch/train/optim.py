"""Optimizers of the train steps: global-norm clipping, then one of the
reference's optimizer family over parameter groups with step-indexed
learning rates; and the pre-training optimizer (`pretrain_optimizer`).

The port of `vln_imagine_tpu/train/optim.py` (the fine-tune optimizers).
The reference builds a 3-group torch optimizer over {contrastive alignment
model, imagine embeddings, everything else} (agent_cmt.py:82-101) and
mutates group learning rates / requires_grad per training stage in its
training script (main.py:200-278):

  stage1 (idx < 0.25*iters):  aux groups lr*10, trainable; rest frozen
  stage2 (0.25 - 0.5*iters):  aux groups lr*5;  rest lr*0.1
  stage3 (>= 0.5*iters):      every group lr*0.1

The JAX package expresses this as optax transforms, and the port follows
its arithmetic, update order and state semantics exactly:

- `clip_by_global_norm(max_norm)` first, over every gradient;
- per group, the transform of `optim` (optax's, with its defaults):
  adam / adamw `scale_by_adam(eps=1e-8)`; radam `scale_by_radam` (b1 0.9,
  b2 0.999, eps 1e-8, threshold 5: the bias-corrected first moment until
  the variance is tractable, then the rectified Adam step); ralamb and
  rangerlars `scale_by_radam` then `scale_by_trust_ratio` (per parameter,
  ||p|| / ||u||, 1 where either norm is 0); rms `scale_by_rms` (decay 0.9,
  eps 1e-8 inside the root, initial scale 0); sgd the identity.  Then
  weight decay if any, then `-lr(count)`; parameters move by p + u;
- `plain_optimizer` with rangerlars wraps the whole chain, clip included,
  in Lookahead (k 6, alpha 0.5) on the update stream, its slow weights
  taken when the optimizer is built.  The warm-up optimizer does not:
  under variant4, rangerlars is Ralamb without Lookahead, as in the JAX
  package (ROADMAP Queue 3);
- the "rest" group sits inside `freeze_until(stage1_end)`: before that step
  it gets no update, no moment update and no count.  Its inner count (and
  so its schedule) therefore starts at 0 when it unfreezes and lags the
  outer step by stage1_end steps: the rest group runs at 1.0x the base lr
  for the first stage1_end steps of stage 2, where the reference has 0.1x.
  This is a defect of the JAX package that the port reproduces on purpose
  (ROADMAP Queue 3), so that the two stay comparable.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

OPTIMS = ("adam", "adamw", "radam", "ralamb", "rangerlars", "rms", "sgd")


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


class ParamGroup:
    """optax's `optim` transform -> `add_decayed_weights` ->
    `scale_by_schedule` over a list of parameters, active from
    `unfreeze_step` on (optax `freeze_until`).  A parameter's moments are
    created at its first gradient: a parameter that never had one has zero
    moments, for which every transform's update is exactly zero, so it is
    skipped, unless weight decay moves it (optax decays every parameter it
    is given, a zero gradient or not).  `state` keys the moments (a tuple
    in `MOMENTS[optim]` order) by the parameter's index in `params`, so
    that they can be saved."""

    MOMENTS = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"),
               "radam": ("mu", "nu"), "ralamb": ("mu", "nu"),
               "rangerlars": ("mu", "nu"), "rms": ("nu",), "sgd": ()}
    b1, b2, eps = 0.9, 0.999, 1e-8  # optax defaults; the JAX package sets eps
    rms_decay, radam_threshold = 0.9, 5.0

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr: Callable[[int], float], weight_decay: float = 0.0,
                 unfreeze_step: int = 0, optim: str = "adamw",
                 b2: float | None = None, eps: float | None = None):
        if optim not in OPTIMS:
            raise ValueError(f"optimizer {optim!r}; one of {OPTIMS}")
        if b2 is not None:
            self.b2 = b2
        if eps is not None:
            self.eps = eps
        self.params = list(params)
        self.lr, self.weight_decay = lr, weight_decay
        self.unfreeze_step = unfreeze_step
        self.optim = optim
        self.moments = self.MOMENTS[optim]
        self.count = 0  # the inner transform / schedule count
        self.state: dict[int, tuple[torch.Tensor, ...]] = {}

    def _factors(self, count: int, dev) -> dict:
        """The step's scalar factors, in f32 as optax computes them."""
        b1t = torch.tensor(self.b1) ** count
        b2t = torch.tensor(self.b2) ** count
        f = {"bc1": (1.0 - b1t).to(dev), "bc2": (1.0 - b2t).to(dev)}
        if self.optim in ("radam", "ralamb", "rangerlars"):
            ro_inf = 2.0 / (1.0 - self.b2) - 1.0
            ro = ro_inf - 2 * count * b2t / (1 - b2t)
            f["rectify"] = bool(ro >= self.radam_threshold)
            f["r"] = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro)).to(dev)
        return f

    def _transform(self, p, g, moments, f):
        """The update direction of one parameter and its new moments."""
        o = self.optim
        if o == "sgd":
            return g, ()
        if o == "rms":
            nu = (1 - self.rms_decay) * (g * g) + self.rms_decay * moments[0]
            return g * torch.rsqrt(nu + self.eps), (nu,)
        mu = (1 - self.b1) * g + self.b1 * moments[0]
        nu = (1 - self.b2) * (g * g) + self.b2 * moments[1]
        mu_hat, nu_hat = mu / f["bc1"], nu / f["bc2"]
        if o in ("adam", "adamw"):
            return mu_hat / (torch.sqrt(nu_hat) + self.eps), (mu, nu)
        u = (f["r"] * mu_hat / (torch.sqrt(nu_hat) + self.eps)
             if f["rectify"] else mu_hat)
        if o != "radam":  # scale_by_trust_ratio
            p_norm = torch.linalg.vector_norm(p)
            u_norm = torch.linalg.vector_norm(u)
            ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(p_norm), p_norm / u_norm)
            u = u * ratio
        return u, (mu, nu)

    @torch.no_grad()
    def step(self, outer_step: int,
             scale: Callable[[torch.Tensor], torch.Tensor] | None) -> None:
        """One update from `p.grad`, each gradient first multiplied by the
        clip factor `scale` (None: no clipping)."""
        if outer_step < self.unfreeze_step or not self.params:
            return
        count = self.count + 1
        f = self._factors(count, self.params[0].device)
        step_size = -self.lr(self.count)
        for i, p in enumerate(self.params):
            g = p.grad
            if g is None and i not in self.state and not self.weight_decay:
                continue
            if g is None:
                g = torch.zeros_like(p)
            elif scale is not None:
                g = scale(g)
            moments = self.state.get(i) or tuple(
                torch.zeros_like(p) for _ in self.moments)
            u, self.state[i] = self._transform(p, g, moments, f)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u * step_size)
        self.count = count

    def state_dict(self) -> dict:
        """The count and each moment by parameter index; a parameter that
        never had a gradient has no entry."""
        out = {"count": self.count}
        for k, name in enumerate(self.moments):
            out[name] = {i: m[k] for i, m in self.state.items()}
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore `state_dict()`'s output: moments present here are
        overwritten in place, moments absent from `state` are dropped (so
        the parameter stays without one), and the rest are created on the
        parameter's device."""
        names = self.moments
        idx = set(state[names[0]]) if names else set()
        if (set(state) != {"count", *names}
                or any(set(state[n]) != idx for n in names)
                or not all(0 <= i < len(self.params) for i in idx)):
            raise ValueError(f"optimizer state {sorted(state)} does not match "
                             f"this {self.optim} group's {len(self.params)} "
                             "parameters")
        for i in list(self.state):
            if i not in idx:
                del self.state[i]
        for i in idx:
            p = self.params[i]
            new = tuple(state[n][i] for n in names)
            for n, m in zip(names, new):
                if m.shape != p.shape:
                    raise ValueError(f"moment {n} {i} has shape "
                                     f"{tuple(m.shape)}, its parameter "
                                     f"{tuple(p.shape)}")
            if i in self.state:
                for cur, m in zip(self.state[i], new):
                    cur.copy_(m)
            else:
                self.state[i] = tuple(m.to(p.device, torch.float32, copy=True)
                                      for m in new)
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
    """clip_by_global_norm(max_grad_norm) (None: no clip) -> one ParamGroup
    per label, optionally inside Lookahead (`lookahead`: the JAX package's
    `lookahead_wrapper`, k 6, alpha 0.5: every k-th step moves each
    parameter to slow + alpha * (fast - slow), which becomes the new slow
    weight; the slow weights start as the parameters at construction).
    `step()` reads `p.grad` and returns the gradient's global norm before
    the clip, as a device tensor (no host sync)."""

    def __init__(self, groups: list[ParamGroup],
                 max_grad_norm: float | None = None, lookahead: bool = False,
                 k: int = 6, alpha: float = 0.5):
        self.groups = groups
        self.max_grad_norm = max_grad_norm
        self.steps = 0
        self.k, self.alpha = k, alpha
        self.slow = ([p.detach().clone() for p in self.params()]
                     if lookahead else None)
        self.lookahead_count = 0

    def params(self):
        return [p for g in self.groups for p in g.params]

    def state_dict(self) -> dict:
        out = {"steps": self.steps,
               "groups": [g.state_dict() for g in self.groups]}
        if self.slow is not None:
            out["lookahead"] = {"count": self.lookahead_count,
                                "slow": dict(enumerate(self.slow))}
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore `state_dict()`'s output in place (the groups keep their
        parameters)."""
        if len(state["groups"]) != len(self.groups):
            raise ValueError(f"optimizer state has {len(state['groups'])} "
                             f"groups, this optimizer {len(self.groups)}")
        if ("lookahead" in state) != (self.slow is not None):
            raise ValueError("optimizer state and this optimizer disagree on "
                             "Lookahead")
        if self.slow is not None:
            slow = state["lookahead"]["slow"]
            if set(slow) != set(range(len(self.slow))) or any(
                    slow[i].shape != s.shape for i, s in enumerate(self.slow)):
                raise ValueError("Lookahead slow weights do not match this "
                                 "optimizer's parameters")
        for group, g_state in zip(self.groups, state["groups"]):
            group.load_state_dict(g_state)
        self.steps = int(state["steps"])
        if self.slow is not None:
            for i, s in enumerate(self.slow):
                s.copy_(slow[i])
            self.lookahead_count = int(state["lookahead"]["count"])

    def zero_grad(self) -> None:
        for p in self.params():
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        params = self.params()
        norm = global_norm(params)
        scale = None
        if self.max_grad_norm:
            trigger = norm < self.max_grad_norm
            max_norm = self.max_grad_norm

            def scale(g):  # optax: select(trigger, g, g / norm * max_norm)
                return torch.where(trigger, g, g / norm * max_norm)
        sync = (self.slow is not None
                and (self.lookahead_count + 1) % self.k == 0)
        before = [p.detach().clone() for p in params] if sync else None
        for group in self.groups:
            group.step(self.steps, scale)
        self.steps += 1
        if self.slow is not None:
            self.lookahead_count += 1
        if sync:
            # optax's update stream: out = new_slow - p_before, p = p + out
            for s, p, p0 in zip(self.slow, params, before):
                s.add_(self.alpha * (p - s))
                p.copy_(p0 + (s - p0))
        return norm


def warmup_variant4_optimizer(named_params, base_lr: float, total_iters: int,
                              optim: str = "adamw", max_grad_norm: float = 40.0,
                              stage1_iters: int = -1, stage2_iters: int = -1,
                              weight_decay: float = 0.0) -> GroupedOptimizer:
    """The 3-stage, 3-group schedule over `named_params` of a HamtModel.
    stage1_iters / stage2_iters are the stage END boundaries; -1 gives the
    reference's 0.25*iters / 0.5*iters (main.py:230,244).  No Lookahead,
    whatever `optim` is (the JAX package's `warmup_variant4_optimizer`)."""
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
        ParamGroup(by_label["contrastive"], aux, weight_decay, optim=optim),
        ParamGroup(by_label["imagine"], aux, weight_decay, optim=optim),
        ParamGroup(by_label["rest"], rest, weight_decay,
                   unfreeze_step=stage1_end, optim=optim),
    ], max_grad_norm)


def plain_optimizer(params, base_lr: float, optim: str = "adamw",
                    max_grad_norm: float | None = 40.0,
                    weight_decay: float = 0.0) -> GroupedOptimizer:
    """(clip ->) `optim` at a constant lr over `params`; rangerlars inside
    Lookahead."""
    return GroupedOptimizer(
        [ParamGroup(params, lambda count: base_lr, weight_decay, optim=optim)],
        max_grad_norm, lookahead=optim == "rangerlars")


def warmup_linear_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """Pre-training lr: linear warm-up then linear decay
    (pretrain_src/optim/sched.py:15-30), in f32 as the JAX package
    computes it; 0 at count 0."""
    def schedule(count: int) -> float:
        c = torch.tensor(float(count))
        if count < warmup_steps:
            return float(base_lr * c / max(warmup_steps, 1))
        return float(base_lr * torch.clamp(
            (total_steps - c) / max(1, total_steps - warmup_steps), min=0.0))

    return schedule


def no_decay_parameter(model: torch.nn.Module, name: str) -> bool:
    """Whether `name` is exempt from weight decay: biases and LayerNorm
    weights (the leaves the JAX package's mask finds by their flax names
    `bias` and `scale`; in torch a LayerNorm's and a Linear's weights share
    one name, so the module type decides).  The pano encoder's packed
    `in_proj_bias` holds the query / key / value biases."""
    from vln_imagine_tpu_torch.models.bert import LayerNormF32

    owner, _, leaf = name.rpartition(".")
    return leaf in ("bias", "in_proj_bias") or (
        leaf == "weight"
        and isinstance(model.get_submodule(owner), LayerNormF32))


def pretrain_optimizer(model: torch.nn.Module, base_lr: float,
                       warmup_steps: int, total_steps: int,
                       weight_decay: float = 0.01,
                       max_grad_norm: float = 5.0) -> GroupedOptimizer:
    """clip_by_global_norm(max_grad_norm) -> Adam (b2 0.98, eps 1e-6) ->
    decoupled weight decay on every parameter but the biases and LayerNorm
    weights (pretrain_src/optim/misc.py:12-37) -> the warm-up-linear lr,
    as the JAX package's optax chain, which moves a parameter without a
    gradient as a zero gradient moves it."""
    sched = warmup_linear_schedule(base_lr, warmup_steps, total_steps)
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        (no_decay if no_decay_parameter(model, name) else decay).append(p)
    return GroupedOptimizer([
        ParamGroup(decay, sched, weight_decay, optim="adam", b2=0.98,
                   eps=1e-6),
        ParamGroup(no_decay, sched, 0.0, optim="adam", b2=0.98, eps=1e-6),
    ], max_grad_norm)
