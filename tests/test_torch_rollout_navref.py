"""REVERIE on HAMT (NavRef: objects, `no_lang_ca`, no imagination) in the
port against the JAX package, on the CPU in f32 at the tiny config with
32-d object features and 3 objects a node, every dropout off:

- the 'teacher', 'sample' (with A2C) and 'argmax' rollouts: paths and
  `pred_obj` identical; `og_loss` (the grounding CE at the goal,
  unweighted), the total loss and the gradient of every model and critic
  parameter within 1e-4;
- one `make_train_step("sample")` step against the JAX step.

The JAX package's init (PRNGKey 42) is carried into the port by the
bridge; NavRef's x-layer language branches have no flax params (never
applied) and get no gradient.  Helpers, draws and tolerances:
tests/test_torch_rollout_variants.py.
"""

import numpy as np
import pytest

from test_torch_rollout_variants import (  # noqa: F401  (fixtures)
    _run_hamt,
    assert_step_matches_jax,
    same_draws,
    setups,
)

# ------------------------------------------------------------ REVERIE HAMT
@pytest.mark.parametrize("feedback, train_ml, train_rl", [
    ("teacher", 1.0, False), ("sample", None, True), ("argmax", None, False)])
def test_navref_rollout_matches_jax(setups, same_draws, feedback, train_ml,
                                    train_rl):
    res, _ = _run_hamt(setups, "reverie_hamt", feedback, train_ml, train_rl)
    w, ep = setups["reverie_hamt"][6:8]
    pred = res.pred_obj.numpy()
    if feedback == "teacher":
        # the grounding CE at the goal, unweighted, inside the total
        assert float(res.og_loss.detach()) > 0
        np.testing.assert_allclose(float(res.loss),
                                   float(res.ml_loss + res.og_loss),
                                   rtol=1e-6)
    # a predicted object is one that the node the item stopped at shows, or
    # -1; an item that moved on every step is forced to stop at T-1 and
    # grounds at the node it moved from
    scan, pn, pl = ep.scan.numpy(), res.path_nodes.numpy(), res.path_len.numpy()
    T = setups["reverie_hamt"][1].env.max_action_len
    for b in range(ep.batch):
        node = pn[b, min(pl[b] - 1, T - 1)]
        shown = w.obj_ids[scan[b], node][w.obj_valid[scan[b], node]]
        assert pred[b] == -1 or pred[b] in shown.tolist()


def test_navref_train_step_matches_jax(setups, same_draws, monkeypatch):
    m, _ = assert_step_matches_jax(setups, "reverie_hamt", monkeypatch,
                                   "sample")
    assert float(m["ml_loss"]) > 0 and float(m["rl_loss"]) != 0
