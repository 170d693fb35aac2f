"""REVERIE on DUET in the port against the JAX package, on the CPU in f32
at the tiny config with 32-d object features and 3 objects a node, every
dropout off:

- the DAgger student ('sample' supervised by the SPL expert), the teacher
  rollout and greedy eval: paths and `pred_obj` (read at the node each item
  ends on, after the stop-node backtrack) identical; `og_loss` (the
  grounding CE on every step whose node shows the target), the total loss,
  the logits and the gradient of every parameter within 1e-4;
- one DAgger `make_train_step()` step against the JAX step.

The port's seeded init is carried into the JAX package by the bridge.
Helpers, draws and tolerances: tests/test_torch_rollout_variants.py.
"""

import jax
import numpy as np
import pytest

from test_torch_rollout_variants import (  # noqa: F401  (fixtures)
    _assert_grads,
    _close,
    assert_step_matches_jax,
    same_draws,
    setups,
)
from vln_imagine_tpu.train.rollout_duet import rollout_duet as j_rollout_duet
from vln_imagine_tpu_torch.ckpt.convert import flax_from_state_dict
from vln_imagine_tpu_torch.ops.dropout import Rng
from vln_imagine_tpu_torch.train.rollout_duet import rollout_duet
from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

# ------------------------------------------------------------ REVERIE DUET
@pytest.mark.parametrize("feedback, train_ml", [
    ("teacher", 1.0), ("sample", 1.0), ("argmax", None)])
def test_reverie_duet_rollout_matches_jax(setups, same_draws, feedback,
                                          train_ml):
    same_draws["stop"] = None
    jcfg, cfg, jtr, _, jw, jep, w, ep, _ = setups["reverie_duet"]
    tr = DuetTrainer(cfg, w, device="cpu")
    tr.model.contrastive_alignment_model.image_proj.rate = 0.0
    training = train_ml is not None
    res = rollout_duet(tr.model, tr.tables, ep, cfg, rng=Rng(0, "cpu"),
                       feedback=feedback, train_ml=train_ml,
                       deterministic=True)
    params = flax_from_state_dict(tr.model.state_dict(), "duet")

    def loss_fn(params):
        r = j_rollout_duet(jtr.model, params, jw, jep, jcfg,
                           jax.random.PRNGKey(3), feedback=feedback,
                           train_ml=train_ml, deterministic=True)
        return r.loss, r

    if training:
        res.loss.backward()
        (_, jres), jg = jax.value_and_grad(loss_fn, has_aux=True)(params)
    else:
        _, jres = loss_fn(params)
    np.testing.assert_array_equal(res.path_len.numpy(),
                                  np.asarray(jres.path_len))
    np.testing.assert_array_equal(res.path_nodes.numpy(),
                                  np.asarray(jres.path_nodes))
    np.testing.assert_array_equal(res.pred_obj.numpy(),
                                  np.asarray(jres.pred_obj))
    assert (res.pred_obj.numpy() != -1).all()  # every item ends by T-1
    for name in ("loss", "ml_loss", "aux_loss", "og_loss"):
        _close(getattr(res, name), getattr(jres, name), name)
    if training:
        assert float(res.og_loss.detach()) > 0
        _close(res.logits, jres.logits, "logits")
        _assert_grads(tr.model, jg, lambda sd: flax_from_state_dict(sd, "duet"),
                      "model grad")
        assert tr.model.og_head.net["0"].weight.grad.abs().max() > 0
    else:
        paths, lens, pred = tr.make_eval_step()(ep)
        np.testing.assert_array_equal(pred.numpy(), res.pred_obj.numpy())


def test_reverie_duet_train_step_matches_jax(setups, same_draws, monkeypatch):
    same_draws["stop"] = None
    m, _ = assert_step_matches_jax(setups, "reverie_duet", monkeypatch)
    assert float(m["dagger_loss"]) > 0
