"""The port's optimizers and train step against the JAX package's, on the
CPU in f32:

- the variant4 warm-up optimizer and the plain (critic) optimizer against
  optax on the same parameters and gradients, over both stage boundaries,
  with the clip active: the updates agree within 1e-6 (both add the same
  f32 operations in the same order; 1e-6 leaves room for the power in the
  bias correction), the frozen group's moments stay untouched, and the
  stage-2 lr lag of the JAX package shows up in both;
- three `make_train_step("teacher")` steps at the tiny config (every
  dropout 0) from the JAX init, against the JAX step: grad_norm, loss and
  every parameter after each step;
- a 'sample' step with every dropout on: finite metrics, the stage-1
  semantics, and two runs from one seed are identical.
"""

import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.envx import synthetic_episodes as j_episodes
from vln_imagine_tpu.envx import synthetic_world as j_world
from vln_imagine_tpu.train.optim import plain_optimizer as j_plain_optimizer
from vln_imagine_tpu.train.optim import (
    warmup_variant4_optimizer as j_warmup_variant4_optimizer,
)
from vln_imagine_tpu.train.trainer import HamtTrainer as JHamtTrainer
from vln_imagine_tpu_torch.ckpt.convert import (
    critic_flax_from_state_dict,
    critic_state_dict_from_flax,
    flax_from_state_dict,
    state_dict_from_flax,
)
from vln_imagine_tpu_torch.config import tiny_test_config
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.train.optim import (
    label_hamt_param,
    plain_optimizer,
    warmup_variant4_optimizer,
)
from vln_imagine_tpu_torch.train.trainer import HamtTrainer

torch.set_num_threads(2)

UPDATE_TOL = 1e-6
LR = 1e-2  # large enough that every update is well above f32 rounding of p

# port parameter name -> the JAX package's flax path (top-level module =
# warm-up group), and a shape
PARAMS = {
    "contrastive_alignment_model.image_proj.fc1.weight":
        (("image_proj", "fc1", "kernel"), (5, 3)),
    "imagine_embeddings.type_embedding.weight":
        (("imagine_embeddings", "type_embedding", "embedding"), (1, 4)),
    "encoder.layer.0.output.dense.weight":
        (("lang_layer_0", "output", "dense", "kernel"), (3, 6)),
    "next_action.net.0.bias": (("next_action", "dense0", "bias"), (7,)),
}


def _tree(values):
    tree = {}
    for name, (path, _) in PARAMS.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(values[name])
    return {"params": tree}


def _get(tree, name):
    node = tree["params"]
    for p in PARAMS[name][0]:
        node = node[p]
    return np.asarray(node)


def _grads(kind, steps=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(steps):
        if kind == "constant":  # global norm sqrt(37) < 40: no clip
            out.append({n: np.ones(s, np.float32) for n, (_, s) in PARAMS.items()})
        else:  # steps 0 and 3 far above the clip norm of 40
            scale = 40.0 if t in (0, 3) else 0.5
            out.append({n: (scale * rng.standard_normal(s)).astype(np.float32)
                        for n, (_, s) in PARAMS.items()})
    return out


def _run_both(grads, port_opt_fn, jax_tx_fn):
    """Apply the same gradients in both packages; returns per-step updates
    {name: (port, jax)} and both optimizers."""
    rng = np.random.default_rng(1)
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, (_, s) in PARAMS.items()}
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for n, v in init.items()}
    opt = port_opt_fn(list(params.items()))
    jparams = _tree(init)
    tx = jax_tx_fn(jparams)
    jstate = tx.init(jparams)
    steps = []
    for g in grads:
        before = {n: p.detach().clone().numpy() for n, p in params.items()}
        jbefore = jparams
        for n, p in params.items():
            p.grad = torch.from_numpy(g[n])
        norm = opt.step()
        updates, jstate = tx.update(_tree(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(_tree(g))),
                                   rtol=1e-6)
        steps.append({n: (params[n].detach().numpy() - before[n],
                          _get(jparams, n) - _get(jbefore, n))
                      for n in PARAMS})
    return steps, opt, jstate


def _variant4(kind):
    return _run_both(
        _grads(kind),
        lambda named: warmup_variant4_optimizer(
            named, LR, 100, "adamw", 40.0, stage1_iters=2, stage2_iters=4),
        j_warmup_variant4_optimizer(LR, 100, "adamw", 40.0, stage1_iters=2,
                                    stage2_iters=4))


@pytest.mark.parametrize("kind", ["random", "constant"])
def test_variant4_optimizer_matches_optax(kind):
    steps, opt, jstate = _variant4(kind)
    for t, step in enumerate(steps):
        for name, (got, want) in step.items():
            np.testing.assert_allclose(got, want, rtol=UPDATE_TOL,
                                       atol=UPDATE_TOL, err_msg=f"step {t} {name}")
            if label_hamt_param(name) == "rest" and t < 2:
                assert not got.any() and not want.any(), "rest moved in stage 1"
            else:
                assert np.abs(got).min() > 0, f"step {t} {name} did not move"
    rest = opt.groups[2]
    assert rest.count == 4  # counted only from the unfreeze step on
    jrest = jstate[1].inner_states["rest"].inner_state
    assert int(jrest.count) == 6 and int(jrest.inner[0].count) == 4


def test_frozen_group_moments_untouched():
    steps, opt, jstate = _run_both(
        _grads("random", steps=2),
        lambda named: warmup_variant4_optimizer(
            named, LR, 100, "adamw", 40.0, stage1_iters=2, stage2_iters=4),
        j_warmup_variant4_optimizer(LR, 100, "adamw", 40.0, stage1_iters=2,
                                    stage2_iters=4))
    rest = opt.groups[2]
    assert rest.count == 0 and not rest.state
    adam = jstate[1].inner_states["rest"].inner_state.inner[0]
    assert int(adam.count) == 0
    for leaf in jax.tree.leaves(adam.mu) + jax.tree.leaves(adam.nu):
        assert not np.asarray(leaf).any()


def test_stage2_lag_in_both_packages():
    """With constant unit gradients Adam's step is ~lr(count) per element.
    The rest group unfreezes at step 2 with its schedule count at 0, so it
    runs at 1.0x lr in steps 2-3 (the reference: 0.1x) and at 0.1x from step
    4; the aux groups run at 10x, 10x, 5x, 5x, 0.1x, 0.1x."""
    steps, _, _ = _variant4("constant")
    for t, want_scale in enumerate([0.0, 0.0, 1.0, 1.0, 0.1, 0.1]):
        for side in (0, 1):
            u = steps[t]["encoder.layer.0.output.dense.weight"][side]
            np.testing.assert_allclose(u, -LR * want_scale, rtol=1e-3)
    for t, want_scale in enumerate([10.0, 10.0, 5.0, 5.0, 0.1, 0.1]):
        for side in (0, 1):
            u = steps[t]["imagine_embeddings.type_embedding.weight"][side]
            np.testing.assert_allclose(u, -LR * want_scale, rtol=1e-3)


def test_plain_optimizer_matches_optax():
    """The critic's optimizer: Adam at a constant lr, no clip."""
    steps, _, _ = _run_both(
        _grads("random"),
        lambda named: plain_optimizer([p for _, p in named], LR, "adamw",
                                      max_grad_norm=None),
        lambda params: j_plain_optimizer(LR, "adamw", max_grad_norm=None))
    for t, step in enumerate(steps):
        for name, (got, want) in step.items():
            np.testing.assert_allclose(got, want, rtol=UPDATE_TOL,
                                       atol=UPDATE_TOL, err_msg=f"step {t} {name}")


# ------------------------------------------------------------ train step
def _world_ep(world_fn, episodes_fn, cfg, batch=2):
    world, _ = world_fn(num_scans=1, num_nodes=14,
                        max_candidates=cfg.env.max_candidates,
                        views=cfg.env.views, feat_dim=cfg.model.image_feat_size,
                        seed=11)
    ep = episodes_fn(world, batch=batch, max_gt_path_len=cfg.env.max_gt_path_len,
                     max_instr_len=cfg.env.max_instr_len,
                     max_imaginations=cfg.model.max_imagination_len,
                     vocab_size=cfg.model.vocab_size,
                     feat_dim=cfg.model.hidden_size, seed=12)
    return world, ep


def _with(cfg, part, **kw):
    return dataclasses.replace(
        cfg, **{part: dataclasses.replace(getattr(cfg, part), **kw)})


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, np.asarray(v)


class _NoDropout(flax.linen.Module):
    """flax.linen.Dropout's signature, the identity."""
    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


def test_teacher_train_steps_match_jax(monkeypatch):
    """Three teacher steps with stage ends 1 and 2 (stage 1, the lagged
    stage 2, stage 3) from the JAX init.  The tiny config sets every
    configurable dropout to 0; the alignment head's fixed 0.15 dropout
    (vilmodel_cmt.py:714-728), active in every train step, is taken out of
    both packages so that they compute the same function.  grad_norm and
    loss agree within
    1e-4 relative (the gradients reach ~1e6, see test_torch_rollout_train).
    Parameters agree within 1e-7 plus 1e-2 of the largest move any
    parameter made so far: Adam's first steps move an element by
    ~lr * sign(g) whatever |g| is, so where a gradient is rounding noise
    (the next-action head's output bias, to which the softmax is blind) the
    two packages may move it in either direction."""
    jcfg = _with(j_tiny_test_config("hamt"), "train", warmup_stage1_iters=1,
                 warmup_stage2_iters=2)
    pcfg = _with(tiny_test_config("hamt"), "train", warmup_stage1_iters=1,
                 warmup_stage2_iters=2)
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    jw_np, jep_np = _world_ep(j_world, j_episodes, jcfg)
    jw, jep = (jax.tree.map(jnp.asarray, x) for x in (jw_np, jep_np))
    jtr = JHamtTrainer(jcfg, jw, rng=jax.random.PRNGKey(42))
    state = jtr.init_state(jep)
    jstep = jtr.make_train_step("teacher", donate=False)

    world, ep = _world_ep(synthetic_world, synthetic_episodes, pcfg)
    tr = HamtTrainer(pcfg, world, device="cpu")
    tr.model.contrastive_alignment_model.image_proj.rate = 0.0
    tr.model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, state.params)), strict=True)
    tr.critic.load_state_dict(critic_state_dict_from_flax(
        jax.tree.map(np.asarray, state.critic_params)), strict=True)
    step = tr.make_train_step("teacher")
    init = dict(_leaves(state.params["params"]))

    for i in range(3):
        state, jm = jstep(state, jep, jep, jax.random.PRNGKey(i))
        m = step(ep, ep)
        for key in ("grad_norm", "loss", "ml_loss", "aux_loss"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=f"step {i} {key}")
        got = dict(_leaves(flax_from_state_dict(tr.model.state_dict())["params"]))
        want = dict(_leaves(state.params["params"]))
        moved = max(np.abs(want[p] - init[p]).max() for p in want)
        for path in want:
            np.testing.assert_allclose(got[path], want[path], rtol=0,
                                       atol=1e-7 + 1e-2 * moved,
                                       err_msg=f"step {i} {path}")
        assert moved > 0
    # the critic gets no gradient from a teacher step
    got = critic_flax_from_state_dict(tr.critic.state_dict())["params"]
    for path, w in _leaves(state.critic_params["params"]):
        mod, leaf = path.split("/")
        np.testing.assert_array_equal(got[mod][leaf], w)


def _sample_trainer(seed=0):
    cfg = tiny_test_config("hamt")
    cfg = _with(cfg, "model", hidden_dropout_prob=0.1,
                attention_probs_dropout_prob=0.1, pred_head_dropout_prob=0.1)
    cfg = _with(cfg, "train", feat_dropout=0.4, warmup_stage1_iters=5,
                warmup_stage2_iters=10)
    world, ep = _world_ep(synthetic_world, synthetic_episodes, cfg, batch=3)
    return HamtTrainer(cfg, world, device="cpu", seed=seed), ep


def test_sample_train_step_with_dropout():
    runs = []
    for _ in range(2):
        tr, ep = _sample_trainer()
        model0 = {k: v.clone() for k, v in tr.model.state_dict().items()}
        critic0 = {k: v.clone() for k, v in tr.critic.state_dict().items()}
        step = tr.make_train_step("sample")
        metrics = [step(ep, ep) for _ in range(2)]
        runs.append((metrics, tr.model.state_dict(), tr.critic.state_dict()))
        for m in metrics:
            assert set(m) == {"loss", "ml_loss", "aux_loss", "rl_loss",
                              "entropy", "grad_norm"}
            assert all(torch.isfinite(v) for v in m.values())
            assert m["grad_norm"] > 0 and m["rl_loss"] != 0 and m["entropy"] > 0
        # stage 1: only the aux groups and the critic move
        for name, v in tr.model.state_dict().items():
            same = torch.equal(v, model0[name])
            assert same == (label_hamt_param(name) == "rest"), name
        assert all(not torch.equal(v, critic0[k])
                   for k, v in tr.critic.state_dict().items())
    (m1, p1, c1), (m2, p2, c2) = runs
    for a, b in zip(m1, m2):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert all(torch.equal(c1[k], c2[k]) for k in c1)
    # dropout is on: another seed takes other masks and actions
    tr, ep = _sample_trainer(seed=1)
    assert tr.make_train_step("sample")(ep, ep)["loss"] != m1[0]["loss"]
