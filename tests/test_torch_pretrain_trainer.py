"""`HamtPretrainer`'s loop against the JAX package's, on the CPU in f32 at
the tiny config, the JAX init carried into the port by the bridge:

- gradient accumulation: `train` with k = 2 against the JAX pre-trainer's
  (optax.MultiSteps) over 4 micro-steps of MLM: the same draws, the
  losses, and every parameter after each micro-step, unchanged between
  the updates;
- `validate` on a held-out split (sap and mrc): per-task loss and
  accuracy within 1e-4.
"""

import jax
import numpy as np
import torch

from vln_imagine_tpu.pretrain.trainer import HamtPretrainer as JPretrainer
from vln_imagine_tpu_torch.ckpt.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from vln_imagine_tpu_torch.pretrain.trainer import HamtPretrainer
from tests.test_torch_pretrain import (
    P,
    TOL,
    _j_world_ep,
    _leaves,
    _pretrain_cfgs,
    _world_ep,
)

torch.set_num_threads(2)


def _pair_of_pretrainers(**over):
    jcfg, cfg = _pretrain_cfgs(**over)
    world, ep = _world_ep(seed=2)
    jw, jep = _j_world_ep(seed=2)
    jpt = JPretrainer(jcfg, jw, jep, image_prob_size=P, donate=False)
    jstate = jpt.init_state()
    pt = HamtPretrainer(cfg, world, ep, image_prob_size=P, device="cpu")
    state = pt.init_state()
    # flax creates a module's parameters at its first use: without an
    # observation task the JAX model has no img_embeddings
    missing, unexpected = pt.model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, jstate.params), "hamt_pretrain"),
        strict=False)
    assert not unexpected and all(k.startswith("img_embeddings.")
                                  for k in missing)
    return jpt, jstate, pt, state, world, jw


def _params(pt):
    """A copy of the port model's parameters, by flax path."""
    return dict(_leaves(flax_from_state_dict(
        {k: v.clone() for k, v in pt.model.state_dict().items()},
        "hamt_pretrain")["params"]))


def test_gradient_accumulation_matches_jax():
    jpt, jstate, pt, state, _, _ = _pair_of_pretrainers(
        tasks=("mlm",), mix_ratio=(1,), gradient_accumulation_steps=2)
    p0 = _params(pt)
    for micro in range(4):
        jstate, jsum = jpt.train(jstate, 1)
        state, summary = pt.train(state, 1)
        assert summary.keys() == jsum.keys()
        for t in jsum:
            np.testing.assert_allclose(summary[t], jsum[t], rtol=TOL,
                                       err_msg=f"micro {micro} {t}")
        got, want = _params(pt), dict(_leaves(
            jax.tree.map(np.asarray, jstate.params)["params"]))
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
    tasks = ("sap", "mrc")
    jpt, jstate, pt, state, world, jw = _pair_of_pretrainers(
        tasks=tasks, mix_ratio=(1, 1))
    _, val = _world_ep(seed=2, batch=5, ep_seed=70)
    _, jval = _j_world_ep(seed=2, batch=5, ep_seed=70)
    jpt.add_validation_split("val_unseen", jw, jval, seed=1)
    pt.add_validation_split("val_unseen", world, val, seed=1)
    want = jpt.validate(jstate, batch_size=3, num_batches=2)
    got = pt.validate(state, batch_size=3, num_batches=2)
    assert got.keys() == want.keys() == set(tasks)
    for t in tasks:
        for k in ("loss", "acc"):
            np.testing.assert_allclose(got[t][k], want[t][k], rtol=TOL,
                                       atol=TOL, err_msg=f"{t} {k}")


