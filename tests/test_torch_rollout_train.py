"""The port's training rollouts against the JAX package's, on the CPU in f32
at the tiny config, from the JAX package's own init (HamtTrainer with
PRNGKey(42), as tests/test_golden.py) carried into the port by the bridge:

- the IL rollout (teacher forcing): paths, per-step logits, losses and the
  gradient of the loss for every parameter;
- the RL rollout ('sample' with both packages' sampling patched to argmax,
  so both take the same actions): losses, entropy, the gradients of model
  and critic;
- tests/goldens.npz's HAMT entries, reproduced by the port.

Tolerances: 1e-4, the repo's parity tolerance (tests/test_reference_parity
_hamt.py:45), for losses, logits and gradients, relative for the gradients
whose magnitude reaches ~1e6 (the LayerNorm of an all-zero padded feature
row divides by sqrt(1e-12)); 2e-4 for the goldens, as tests/test_golden.py.
"""

import os

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

torch.set_num_threads(2)

TOL = 1e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens.npz")
GOLDEN_TOL = 2e-4


def _world_ep(world_fn, episodes_fn, cfg):
    """tests/test_golden.py's world and episodes (seeds 11 / 12, batch 2)."""
    world, _ = world_fn(num_scans=1, num_nodes=14,
                        max_candidates=cfg.env.max_candidates,
                        views=cfg.env.views, feat_dim=cfg.model.image_feat_size,
                        seed=11)
    ep = episodes_fn(world, batch=2, max_gt_path_len=cfg.env.max_gt_path_len,
                     max_instr_len=cfg.env.max_instr_len,
                     max_imaginations=cfg.model.max_imagination_len,
                     vocab_size=cfg.model.vocab_size,
                     feat_dim=cfg.model.hidden_size, seed=12)
    return world, ep


@pytest.fixture(scope="module")
def setup():
    jcfg = j_tiny_test_config("hamt")
    jw_np, jep_np = _world_ep(j_world, j_episodes, jcfg)
    jw, jep = (jax.tree.map(jnp.asarray, x) for x in (jw_np, jep_np))
    jtr = JHamtTrainer(jcfg, jw, rng=jax.random.PRNGKey(42))
    state = jtr.init_state(jep)
    cfg = tiny_test_config("hamt")
    world, ep = _world_ep(synthetic_world, synthetic_episodes, cfg)
    return jtr, jcfg, jw, jep, state, cfg, world.to("cpu"), ep.to("cpu")


def _port_modules(state, cfg):
    model = HamtModel(cfg.model, feat_dropout=cfg.train.feat_dropout)
    model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, state.params)), strict=True)
    critic = Critic(cfg.model)
    critic.load_state_dict(critic_state_dict_from_flax(
        jax.tree.map(np.asarray, state.critic_params)), strict=True)
    return model, critic


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, np.asarray(v)


def _assert_grads(module, want_tree, to_flax, what):
    """Every parameter's .grad (None counts as zero) against the JAX
    gradient tree, leaf by leaf."""
    got = to_flax({n: (p.grad if p.grad is not None else torch.zeros_like(p))
                   for n, p in module.named_parameters()})
    got, want = dict(_leaves(got["params"])), dict(_leaves(want_tree["params"]))
    assert set(got) == set(want), what
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=TOL, atol=TOL,
                                   err_msg=f"{what} {path}")
    assert any(np.abs(w).max() > 0 for w in want.values())


def _assert_close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL, err_msg=what)


def test_il_rollout_losses_logits_and_grads_match_jax(setup):
    jtr, jcfg, jw, jep, state, cfg, world, ep = setup
    model, _ = _port_modules(state, cfg)
    res = rollout_hamt(model, world, ep, cfg, feedback="teacher", train_ml=1.0,
                       deterministic=True)
    res.loss.backward()

    def loss_fn(params):
        r = j_rollout(jtr.model, jtr.critic, params, state.critic_params, jw,
                      jep, jcfg, jax.random.PRNGKey(7), feedback="teacher",
                      train_ml=1.0, train_rl=False, deterministic=True)
        return r.loss, r

    (_, jres), jgrad = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    np.testing.assert_array_equal(res.path_nodes.numpy(),
                                  np.asarray(jres.path_nodes))
    np.testing.assert_array_equal(res.actions.numpy(), np.asarray(jres.actions))
    assert (res.path_len.numpy() > 1).all()
    for name in ("loss", "ml_loss", "aux_loss", "logits"):
        _assert_close(getattr(res, name), getattr(jres, name), name)
    _assert_grads(model, jgrad, flax_from_state_dict, "model grad")


def test_rl_rollout_losses_and_grads_match_jax(setup, monkeypatch):
    """'sample' feedback with train_rl, both packages' sampling patched to
    argmax and every dropout off, so both take the same actions and the
    A2C loss, entropy and gradients must agree."""
    jtr, jcfg, jw, jep, state, cfg, world, ep = setup
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1, **kw:
                        jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(port_rollout, "sample_categorical",
                        lambda logp, generator: torch.argmax(logp, dim=-1))
    model, critic = _port_modules(state, cfg)
    res = rollout_hamt(model, world, ep, cfg, rng=Rng(0, "cpu"), critic=critic,
                       feedback="sample", train_rl=True, deterministic=True)
    res.loss.backward()

    def loss_fn(params, critic_params):
        r = j_rollout(jtr.model, jtr.critic, params, critic_params, jw, jep,
                      jcfg, jax.random.PRNGKey(3), feedback="sample",
                      train_ml=None, train_rl=True, deterministic=True)
        return r.loss, r

    (_, jres), (jg, jgc) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(state.params,
                                               state.critic_params)
    np.testing.assert_array_equal(res.actions.numpy(), np.asarray(jres.actions))
    np.testing.assert_array_equal(res.path_nodes.numpy(),
                                  np.asarray(jres.path_nodes))
    assert float(res.rl_loss.detach()) != 0.0
    for name in ("loss", "rl_loss", "aux_loss", "entropy_sum", "logits"):
        _assert_close(getattr(res, name), getattr(jres, name), name)
    _assert_grads(model, jg, flax_from_state_dict, "model grad")
    _assert_grads(critic, jgc, critic_flax_from_state_dict, "critic grad")


def test_port_reproduces_goldens(setup):
    *_, state, cfg, world, ep = setup
    model, _ = _port_modules(state, cfg)
    res = rollout_hamt(model, world, ep, cfg, feedback="teacher", train_ml=1.0,
                       deterministic=True)
    want = dict(np.load(GOLDEN))
    got = {"hamt_ml_loss": res.ml_loss, "hamt_aux_loss": res.aux_loss,
           "hamt_logits_t0": res.logits[0], "hamt_paths": res.path_nodes}
    for key, value in got.items():
        value = value.detach().numpy()
        if key.endswith("_paths"):
            np.testing.assert_array_equal(value, want[key], err_msg=key)
        else:
            np.testing.assert_allclose(value, want[key], rtol=GOLDEN_TOL,
                                       atol=GOLDEN_TOL, err_msg=key)
