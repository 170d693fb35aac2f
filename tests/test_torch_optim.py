"""The port's optimizer family against the JAX package's optax chains, in f32
on the CPU: each of adam, adamw, radam, ralamb, rangerlars, rms and sgd, as
the plain optimizer (clip 40; rangerlars inside Lookahead) and as the
variant4 warm-up optimizer (three groups, stage ends 2 and 4; no
Lookahead), over 8 steps of the same gradients, two of them far above the
clip norm.  Every parameter after every step agrees within 1e-5.  A
`state_dict` taken mid-Lookahead and loaded into a fresh optimizer over a
copy of the parameters gives the same bits over the next steps, across a
Lookahead sync.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vln_imagine_tpu.train.optim import plain_optimizer as j_plain_optimizer
from vln_imagine_tpu.train.optim import (
    warmup_variant4_optimizer as j_warmup_variant4_optimizer,
)
from vln_imagine_tpu_torch.train.optim import (
    OPTIMS,
    plain_optimizer,
    warmup_variant4_optimizer,
)

torch.set_num_threads(2)

PARAM_TOL = 1e-5
LR = 1e-2
STEPS = 8

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


def _grads(steps=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(steps):
        scale = 40.0 if t in (0, 3) else 0.5  # steps 0 and 3 get clipped
        out.append({n: (scale * rng.standard_normal(s)).astype(np.float32)
                    for n, (_, s) in PARAMS.items()})
    return out


def _params(seed=1):
    rng = np.random.default_rng(seed)
    return {n: torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)))
        for n, (_, s) in PARAMS.items()}


def _build(mode, optim, params):
    named = list(params.items())
    if mode == "plain":
        return plain_optimizer([p for _, p in named], LR, optim, 40.0)
    return warmup_variant4_optimizer(named, LR, 100, optim, 40.0,
                                     stage1_iters=2, stage2_iters=4)


def _jax_tx(mode, optim, jparams):
    if mode == "plain":
        return j_plain_optimizer(LR, optim, 40.0)
    return j_warmup_variant4_optimizer(LR, 100, optim, 40.0, stage1_iters=2,
                                       stage2_iters=4)(jparams)


def _step(opt, params, g):
    for n, p in params.items():
        p.grad = torch.from_numpy(g[n])
    return opt.step()


@pytest.mark.parametrize("mode", ["plain", "variant4"])
@pytest.mark.parametrize("optim", OPTIMS)
def test_optimizer_matches_optax_over_8_steps(optim, mode):
    params = _params()
    init = {n: p.detach().clone().numpy() for n, p in params.items()}
    opt = _build(mode, optim, params)
    jparams = _tree(init)
    tx = _jax_tx(mode, optim, jparams)
    jstate = tx.init(jparams)
    for t, g in enumerate(_grads()):
        norm = _step(opt, params, g)
        updates, jstate = tx.update(_tree(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(_tree(g))),
                                   rtol=1e-6)
        for n, p in params.items():
            got = p.detach().numpy()
            np.testing.assert_allclose(got, _get(jparams, n), rtol=0,
                                       atol=PARAM_TOL,
                                       err_msg=f"{optim} {mode} step {t} {n}")
    for n, p in params.items():
        assert np.abs(p.detach().numpy() - init[n]).max() > 1e-4, n
    assert (opt.slow is not None) == (mode == "plain" and optim == "rangerlars")


def test_state_dict_round_trip_mid_lookahead():
    """Three rangerlars steps, then the state into a fresh optimizer over a
    copy of the parameters: five more steps (a Lookahead sync at step 6)
    give the same bits on both."""
    grads = _grads()
    params = _params()
    opt = _build("plain", "rangerlars", params)
    for g in grads[:3]:
        _step(opt, params, g)
    state = opt.state_dict()
    assert state["lookahead"]["count"] == 3
    copy = {n: torch.nn.Parameter(p.detach().clone())
            for n, p in params.items()}
    opt2 = _build("plain", "rangerlars", copy)  # slow weights: the copy's
    opt2.load_state_dict(state)
    for g in grads[3:]:
        _step(opt, params, g)
        _step(opt2, copy, g)
        for n in params:
            assert torch.equal(params[n], copy[n]), n
    assert opt2.lookahead_count == 8 and opt2.steps == 8
    for s, s2 in zip(opt.slow, opt2.slow):
        assert torch.equal(s, s2)
    fresh = _build("plain", "adamw", _params())
    with pytest.raises(ValueError, match="Lookahead"):
        fresh.load_state_dict(state)
