"""Greedy HAMT eval of the port against the JAX package on the synthetic
world at the golden seeds: identical trajectories from `make_eval_step`, and
per-step logits within 1e-4 of `rollout_hamt(feedback="argmax")`."""

import dataclasses

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
from vln_imagine_tpu_torch.ckpt.convert import flax_from_state_dict
from vln_imagine_tpu_torch.config import tiny_test_config
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.eval.metrics import (
    eval_batch,
    trajectories_from_rollout,
)
from vln_imagine_tpu_torch.train.rollout_hamt import make_eval_fn, rollout_hamt
from vln_imagine_tpu_torch.train.trainer import HamtTrainer

torch.set_num_threads(2)

TOL = 1e-4  # tests/test_reference_parity_hamt.py:45
BATCH = 6


def _build(world_fn, episodes_fn, cfg):
    world, _ = world_fn(num_scans=1, num_nodes=14,
                        max_candidates=cfg.env.max_candidates,
                        views=cfg.env.views, feat_dim=cfg.model.image_feat_size,
                        seed=11)
    ep = episodes_fn(world, batch=BATCH, max_gt_path_len=cfg.env.max_gt_path_len,
                     max_instr_len=cfg.env.max_instr_len,
                     max_imaginations=cfg.model.max_imagination_len,
                     vocab_size=cfg.model.vocab_size,
                     feat_dim=cfg.model.hidden_size, seed=12)
    return world, ep


def _with_train(cfg, **kw):
    return cfg.replace(train=dataclasses.replace(cfg.train, **kw))


@pytest.fixture(scope="module")
def setup():
    pcfg = tiny_test_config("hamt")
    world, ep = _build(synthetic_world, synthetic_episodes, pcfg)
    trainer = HamtTrainer(pcfg, world, device="cpu", seed=3)
    params = flax_from_state_dict(trainer.model.state_dict())
    jcfg = j_tiny_test_config("hamt")
    jw_np, jep_np = _build(j_world, j_episodes, jcfg)
    jw = jax.tree.map(jnp.asarray, jw_np)
    jep = jax.tree.map(jnp.asarray, jep_np)
    return trainer, world, ep, params, jcfg, jw, jep


def test_make_eval_step_paths_identical(setup):
    trainer, world, ep, params, jcfg, jw, jep = setup
    path_nodes, path_len = trainer.make_eval_step()(ep)
    jtr = JHamtTrainer(jcfg, jw)
    j_nodes, j_len = jtr.make_eval_step()(params, jep, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(path_nodes.numpy(), np.asarray(j_nodes))
    np.testing.assert_array_equal(path_len.numpy(), np.asarray(j_len))
    assert (path_len.numpy() > 1).any(), "some agent must move"

    # make_eval_fn is the same rollout; metrics read its trajectories
    e_nodes, e_len = make_eval_fn(trainer.model, world, trainer.cfg,
                                  device="cpu")(ep)
    assert torch.equal(e_nodes, path_nodes) and torch.equal(e_len, path_len)
    summary, _ = eval_batch(np.asarray(world.dist), np.asarray(ep.scan),
                            trajectories_from_rollout(e_nodes.numpy(),
                                                      e_len.numpy()),
                            [list(p[:n]) for p, n in zip(ep.gt_path, ep.gt_len)])
    assert 0.0 <= summary["sr"] <= 100.0 and np.isfinite(summary["nDTW"])


@pytest.mark.parametrize("no_cand_backtrack", [False, True])
def test_per_step_logits_match_jax(setup, no_cand_backtrack):
    trainer, world, ep, params, jcfg, jw, jep = setup
    pcfg = _with_train(trainer.cfg, no_cand_backtrack=no_cand_backtrack)
    jcfg = _with_train(jcfg, no_cand_backtrack=no_cand_backtrack)
    res = rollout_hamt(trainer.model, trainer.tables, ep.to("cpu"), pcfg,
                       early_exit=False)
    jtr = JHamtTrainer(jcfg, jw)
    jres = jax.jit(lambda p: j_rollout(
        jtr.model, jtr.critic, p, None, jw, jep, jcfg, jax.random.PRNGKey(0),
        feedback="argmax", train_ml=None, early_exit=False))(params)
    want = np.asarray(jres.logits)
    got = res.logits.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(res.actions.numpy(), np.asarray(jres.actions))
    np.testing.assert_array_equal(res.path_nodes.numpy(),
                                  np.asarray(jres.path_nodes))
