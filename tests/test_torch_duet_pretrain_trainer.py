"""`DuetPretrainer`'s loop against the JAX package's, on the CPU in f32 at
the tiny config, the port's init carried into the JAX pre-trainer by the
bridge (its `init_state` draws and splits as the JAX one does):

- gradient accumulation: `train` with k = 2 over 4 micro-steps of mrc
  against the JAX pre-trainer's (optax.MultiSteps): the same draws, the
  losses, and every parameter after each micro-step, unchanged between
  the updates (the global branch, which mrc does not read, moves by
  weight decay alone in both);
- `validate` on a held-out split of a world with objects, every task (og
  included): per-task loss and accuracy within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np

from vln_imagine_tpu.config import _replace as j_replace
from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.pretrain.trainer import DuetPretrainer as JPretrainer
from vln_imagine_tpu.pretrain.trainer import PretrainState as JState
from vln_imagine_tpu_torch.ckpt.convert import flax_from_state_dict
from vln_imagine_tpu_torch.config import _replace, tiny_test_config
from vln_imagine_tpu_torch.pretrain.trainer import DuetPretrainer
from tests.test_torch_duet_pretrain import (
    FOUR,
    OBJECTS,
    P,
    TOL,
    _episodes,
    _world_ep,
)
from tests.test_torch_pretrain import _leaves


def _params(pt):
    """A copy of the port model's weights as JAX params."""
    return flax_from_state_dict(
        {k: v.clone() for k, v in pt.model.state_dict().items()},
        "duet_pretrain")


def _pair(tasks, objects=0, **over):
    """The JAX pre-trainer and the port's on the same world, episodes and
    config.  The JAX state holds the port's init; making it consumes the
    JAX `init_state`'s rng split and size-2 probe draws."""
    over = dict(dict(tasks=tasks, mix_ratio=(1,) * len(tasks), lr=1e-3,
                     warmup_steps=1, num_train_steps=10, batch_size=2,
                     seed=5), **over)
    jcfg = j_replace(j_tiny_test_config("duet"), "pretrain", **over)
    cfg = _replace(tiny_test_config("duet"), "pretrain", **over)
    world, ep = _world_ep(seed=2, objects=objects)
    pt = DuetPretrainer(cfg, world, ep, image_prob_size=P, device="cpu")
    state = pt.init_state()
    jpt = JPretrainer(jcfg, world, ep, image_prob_size=P, donate=False)
    _, jpt._rng = jax.random.split(jpt._rng)
    for t in tasks:
        jpt.batcher.task_batch(t, 2)
    params = jax.tree.map(jnp.asarray, _params(pt))
    jstate = JState(step=jnp.zeros([], jnp.int32), params=params,
                    opt_state=jpt.tx.init(params))
    return jpt, jstate, pt, state, world


def test_gradient_accumulation_matches_jax():
    jpt, jstate, pt, state, _ = _pair(("mrc",),
                                      gradient_accumulation_steps=2)
    p0 = dict(_leaves(_params(pt)["params"]))
    for micro in range(4):
        jstate, jsum = jpt.train(jstate, 1)
        state, summary = pt.train(state, 1)
        assert summary.keys() == jsum.keys()
        for t in jsum:
            np.testing.assert_allclose(summary[t], jsum[t], rtol=TOL,
                                       err_msg=f"micro {micro} {t}")
        got = dict(_leaves(_params(pt)["params"]))
        want = dict(_leaves(jax.tree.map(np.asarray, jstate.params)[
            "params"]))
        if micro == 0:  # no update between the accumulation boundaries
            assert all(np.array_equal(got[p], p0[p]) for p in p0)
        moved = max(np.abs(want[p] - p0[p]).max() for p in want)
        for path in want:
            np.testing.assert_allclose(got[path], want[path], rtol=0,
                                       atol=1e-7 + 1e-2 * moved,
                                       err_msg=f"micro {micro} {path}")
    assert state.step == int(jstate.step) == 4
    assert moved > 0 and pt.optimizer.steps == 2


def test_validate_matches_jax():
    jpt, jstate, pt, state, world = _pair(FOUR, OBJECTS)
    val_ep = _episodes(world, 5, seed=7)
    jpt.add_validation_split("val_unseen", world, val_ep, seed=3)
    pt.add_validation_split("val_unseen", world, val_ep, seed=3)
    want = jpt.validate(jstate, batch_size=3, num_batches=2)
    got = pt.validate(state, batch_size=3, num_batches=2)
    assert got.keys() == want.keys() == set(FOUR)
    for t in want:
        for k in ("loss", "acc"):
            np.testing.assert_allclose(got[t][k], want[t][k], rtol=TOL,
                                       atol=TOL, err_msg=f"{t} {k}")
    assert all(got[t]["loss"] > 0 for t in got)
