"""The fused IL + RL rollout ('mixed' feedback, `fused_sample_rollout`) of
the port, the twin of tests/test_fused_rollout.py, on the CPU in f32 at the
tiny config from the JAX package's init (HamtTrainer with PRNGKey(42))
carried into the port by the bridge, every dropout off:

- all-IL 'mixed' equals the teacher rollout, all-RL 'mixed' the sampled one;
- the halves of a fused batch give the losses and the gradients of the two
  separate rollouts they replace (aux = the sum of each half's own mean);
- the fused rollout and the fused train step against the JAX package's.

Sampling is patched to argmax in both packages (tests/test_torch_rollout_
train.py), so that both take the same actions.  Tolerance 1e-4 (relative
for gradients), as tests/test_torch_rollout_train.py.
"""

import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.envx import synthetic_episodes as j_episodes
from vln_imagine_tpu.envx import synthetic_world as j_world
from vln_imagine_tpu.train.rollout_hamt import rollout_hamt as j_rollout
from vln_imagine_tpu.train.trainer import HamtTrainer as JHamtTrainer
from vln_imagine_tpu_torch.ckpt.convert import (
    critic_flax_from_state_dict,
    critic_state_dict_from_flax,
    flax_from_state_dict,
    state_dict_from_flax,
)
from vln_imagine_tpu_torch.config import tiny_test_config
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.models.bert import Critic
from vln_imagine_tpu_torch.models.hamt import HamtModel
from vln_imagine_tpu_torch.ops.dropout import Rng
from vln_imagine_tpu_torch.train import rollout_hamt as port_rollout
from vln_imagine_tpu_torch.train.rollout_hamt import rollout_hamt
from vln_imagine_tpu_torch.train.trainer import HamtTrainer, concat_episodes

torch.set_num_threads(2)

TOL = 1e-4


def _world_eps(world_fn, episodes_fn, cfg, convert=lambda x: x):
    world, _ = world_fn(num_scans=1, num_nodes=14,
                        max_candidates=cfg.env.max_candidates,
                        views=cfg.env.views, feat_dim=cfg.model.image_feat_size,
                        seed=11)
    eps = [convert(episodes_fn(
        world, batch=2, max_gt_path_len=cfg.env.max_gt_path_len,
        max_instr_len=cfg.env.max_instr_len,
        max_imaginations=cfg.model.max_imagination_len,
        vocab_size=cfg.model.vocab_size, feat_dim=cfg.model.hidden_size,
        seed=seed)) for seed in (12, 13)]
    return convert(world), eps


@pytest.fixture(scope="module")
def setup():
    jcfg = j_tiny_test_config("hamt")
    jw, jeps = _world_eps(j_world, j_episodes, jcfg,
                          lambda x: jax.tree.map(jnp.asarray, x))
    jtr = JHamtTrainer(jcfg, jw, rng=jax.random.PRNGKey(42))
    state = jtr.init_state(jeps[0])
    cfg = tiny_test_config("hamt")
    world, eps = _world_eps(synthetic_world, synthetic_episodes, cfg)
    return jtr, jcfg, jw, jeps, state, cfg, world.to("cpu"), [
        e.to("cpu") for e in eps]


@pytest.fixture
def argmax_sampling(monkeypatch):
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1, **kw:
                        jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(port_rollout, "sample_categorical",
                        lambda logp, generator: torch.argmax(logp, dim=-1))


def _modules(state, cfg):
    model = HamtModel(cfg.model, feat_dropout=cfg.train.feat_dropout)
    model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, state.params)), strict=True)
    critic = Critic(cfg.model)
    critic.load_state_dict(critic_state_dict_from_flax(
        jax.tree.map(np.asarray, state.critic_params)), strict=True)
    return model, critic


def _run(model, critic, world, ep, cfg, **kw):
    return rollout_hamt(model, world, ep, cfg, rng=Rng(0, "cpu"),
                        critic=critic, deterministic=True, **kw)


def _mixed(model, critic, world, ep, cfg, il):
    return _run(model, critic, world, ep, cfg, feedback="mixed",
                train_ml=0.2, train_rl=True,
                il_mask=torch.tensor(il, dtype=torch.bool))


def _grads(module):
    return {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
            for n, p in module.named_parameters()}


def _zero(*modules):
    for m in modules:
        for p in m.parameters():
            p.grad = None


def _assert_close(got, want, what):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(),
                               np.asarray(torch.as_tensor(want).detach()),
                               rtol=TOL, atol=TOL, err_msg=what)


def test_all_il_mixed_equals_teacher(setup):
    *_, state, cfg, world, (ep, _) = setup
    model, critic = _modules(state, cfg)
    mixed = _mixed(model, critic, world, ep, cfg, [True, True])
    teach = _run(model, critic, world, ep, cfg, feedback="teacher",
                 train_ml=0.2)
    for name in ("ml_loss", "aux_loss", "loss"):
        _assert_close(getattr(mixed, name), getattr(teach, name), name)
    np.testing.assert_array_equal(mixed.path_nodes.numpy(),
                                  teach.path_nodes.numpy())
    assert float(mixed.rl_loss) == 0.0 and float(mixed.entropy_sum) == 0.0


def test_all_rl_mixed_equals_sample(setup, argmax_sampling):
    *_, state, cfg, world, (ep, _) = setup
    model, critic = _modules(state, cfg)
    mixed = _mixed(model, critic, world, ep, cfg, [False, False])
    samp = _run(model, critic, world, ep, cfg, feedback="sample",
                train_rl=True)
    np.testing.assert_array_equal(mixed.actions.numpy(), samp.actions.numpy())
    for name in ("rl_loss", "entropy_sum", "aux_loss"):
        _assert_close(getattr(mixed, name), getattr(samp, name), name)
    assert float(mixed.ml_loss) == 0.0 and float(mixed.rl_loss) != 0.0


def test_fused_halves_equal_separate_rollouts(setup, argmax_sampling):
    """Losses and the gradient of every model and critic parameter."""
    *_, state, cfg, world, (ep_il, ep_rl) = setup
    model, critic = _modules(state, cfg)
    mixed = _mixed(model, critic, world, concat_episodes(ep_il, ep_rl), cfg,
                   [True, True, False, False])
    mixed.loss.backward()
    g_model, g_critic = _grads(model), _grads(critic)
    _zero(model, critic)
    teach = _run(model, critic, world, ep_il, cfg, feedback="teacher",
                 train_ml=0.2)
    samp = _run(model, critic, world, ep_rl, cfg, feedback="sample",
                train_rl=True)
    (teach.loss + samp.loss).backward()
    _assert_close(mixed.ml_loss, teach.ml_loss, "ml_loss")
    _assert_close(mixed.rl_loss, samp.rl_loss, "rl_loss")
    _assert_close(mixed.aux_loss, teach.aux_loss + samp.aux_loss, "aux_loss")
    _assert_close(mixed.loss, teach.loss + samp.loss, "loss")
    np.testing.assert_array_equal(mixed.path_nodes[:2].numpy(),
                                  teach.path_nodes.numpy())
    for module, fused in ((model, g_model), (critic, g_critic)):
        sep = _grads(module)
        for n in fused:
            np.testing.assert_allclose(fused[n].numpy(), sep[n].numpy(),
                                       rtol=TOL, atol=TOL * max(
                                           1.0, float(sep[n].abs().max())),
                                       err_msg=n)
    assert any(float(g.abs().max()) > 0 for g in g_critic.values())


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, np.asarray(v)


def _assert_grads(module, want_tree, to_flax, what):
    got = to_flax(_grads(module))
    got, want = dict(_leaves(got["params"])), dict(_leaves(want_tree["params"]))
    assert set(got) == set(want), what
    for path in want:
        # relative to the leaf's scale: the LayerNorm of an all-zero padded
        # feature row gives gradients of ~1e6 (tests/test_torch_rollout_train)
        np.testing.assert_allclose(
            got[path], want[path], rtol=TOL,
            atol=TOL * max(1.0, float(np.abs(want[path]).max())),
            err_msg=f"{what} {path}")


def test_fused_rollout_matches_jax(setup, argmax_sampling):
    jtr, jcfg, jw, (jep_il, jep_rl), state, cfg, world, (ep_il, ep_rl) = setup
    model, critic = _modules(state, cfg)
    mixed = _mixed(model, critic, world, concat_episodes(ep_il, ep_rl), cfg,
                   [True, True, False, False])
    mixed.loss.backward()
    jep = jax.tree.map(lambda a, b: jnp.concatenate([a, b], 0), jep_il, jep_rl)
    il_m = jnp.asarray([True, True, False, False])

    def loss_fn(params, critic_params):
        r = j_rollout(jtr.model, jtr.critic, params, critic_params, jw, jep,
                      jcfg, jax.random.PRNGKey(3), feedback="mixed",
                      train_ml=0.2, train_rl=True, deterministic=True,
                      il_mask=il_m)
        return r.loss, r

    (_, jres), (jg, jgc) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(state.params,
                                               state.critic_params)
    np.testing.assert_array_equal(mixed.actions.numpy(),
                                  np.asarray(jres.actions))
    np.testing.assert_array_equal(mixed.path_nodes.numpy(),
                                  np.asarray(jres.path_nodes))
    for name in ("loss", "ml_loss", "rl_loss", "aux_loss", "entropy_sum",
                 "logits"):
        _assert_close(getattr(mixed, name), getattr(jres, name), name)
    _assert_grads(model, jg, flax_from_state_dict, "model grad")
    _assert_grads(critic, jgc, critic_flax_from_state_dict, "critic grad")


class _NoDropout(flax.linen.Module):
    """flax.linen.Dropout's signature, the identity."""
    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


def _with(cfg, part, **kw):
    return dataclasses.replace(
        cfg, **{part: dataclasses.replace(getattr(cfg, part), **kw)})


def test_fused_train_step_matches_jax(setup, argmax_sampling, monkeypatch):
    """Two `fused_sample_rollout` steps (stage ends 1 and 2) from the JAX
    init: the metrics and every parameter, as
    tests/test_torch_train.py's teacher steps."""
    _, jcfg, jw, (jep_il, jep_rl), _, cfg, world, (ep_il, ep_rl) = setup
    over = dict(fused_sample_rollout=True, warmup_stage1_iters=1,
                warmup_stage2_iters=2)
    jcfg, cfg = _with(jcfg, "train", **over), _with(cfg, "train", **over)
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    jtr = JHamtTrainer(jcfg, jw, rng=jax.random.PRNGKey(42))
    state = jtr.init_state(jep_il)
    jstep = jtr.make_train_step("sample", donate=False)
    tr = HamtTrainer(cfg, world, device="cpu")
    tr.model.contrastive_alignment_model.image_proj.rate = 0.0
    tr.critic.rate = 0.0  # the critic's fixed 0.5 dropout, as flax's above
    tr.model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, state.params)), strict=True)
    tr.critic.load_state_dict(critic_state_dict_from_flax(
        jax.tree.map(np.asarray, state.critic_params)), strict=True)
    step = tr.make_train_step("sample")
    init = dict(_leaves(state.params["params"]))
    for i in range(2):
        state, jm = jstep(state, jep_il, jep_rl, jax.random.PRNGKey(i))
        m = step(ep_il, ep_rl)
        for key in ("loss", "ml_loss", "rl_loss", "aux_loss", "entropy",
                    "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i} {key}")
        assert float(m["rl_loss"]) != 0.0
        got = dict(_leaves(flax_from_state_dict(tr.model.state_dict())["params"]))
        want = dict(_leaves(state.params["params"]))
        moved = max(np.abs(want[p] - init[p]).max() for p in want)
        assert moved > 0
        for path in want:
            np.testing.assert_allclose(got[path], want[path], rtol=0,
                                       atol=1e-7 + 1e-2 * moved,
                                       err_msg=f"step {i} {path}")
        gotc = critic_flax_from_state_dict(tr.critic.state_dict())
        for path, w in _leaves(state.critic_params["params"]):
            np.testing.assert_allclose(dict(_leaves(gotc["params"]))[path], w,
                                       rtol=0, atol=1e-5, err_msg=path)
