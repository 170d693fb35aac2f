"""The port's DUET rollouts and trainer against the JAX package's, on the CPU
in f32 at the tiny config, from the JAX package's own init
(DuetTrainer with PRNGKey(42), as tests/test_golden.py) carried into the
port by the bridge:

- greedy eval: the paths of `make_eval_step` equal, item for item;
- the teacher-forced IL rollout: paths, actions, per-step logits, losses
  and the gradient of the loss for every parameter, `sprel_linear`'s
  (through the attention's dBias) included and nonzero;
- the 'sample' rollout with both packages' sampling patched to argmax and
  supervised by the SPL expert: losses, entropy, gradients;
- tests/goldens.npz's DUET entries, reproduced by the port;
- three 'imitation' train steps against the JAX step, and one DAgger step
  with every dropout on (finite metrics, stage-1 semantics, two runs from
  one seed identical).

Tolerances: 1e-4 (the repo's parity tolerance) for losses, logits and
gradients, relative where a gradient is large; 2e-4 for the goldens, as
tests/test_golden.py; parameters after a step as in
tests/test_torch_train.py.
"""

import dataclasses
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.envx import synthetic_episodes as j_episodes
from vln_imagine_tpu.envx import synthetic_world as j_world
from vln_imagine_tpu.train.rollout_duet import rollout_duet as j_rollout
from vln_imagine_tpu.train import trainer_duet as j_trainer_duet
from vln_imagine_tpu.train.trainer_duet import DuetTrainer as JDuetTrainer
from vln_imagine_tpu_torch.ckpt.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from vln_imagine_tpu_torch.config import tiny_test_config
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.models.duet import DuetModel
from vln_imagine_tpu_torch.ops.dropout import Rng
from vln_imagine_tpu_torch.train import rollout_duet as port_rollout
from vln_imagine_tpu_torch.train.optim import label_hamt_param
from vln_imagine_tpu_torch.train.rollout_duet import rollout_duet
from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

torch.set_num_threads(2)

TOL = 1e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens.npz")
GOLDEN_TOL = 2e-4


def _world_ep(world_fn, episodes_fn, cfg, golden=True):
    """tests/test_golden.py's world and episodes (seeds 11 / 12, batch 2),
    or tests/test_duet.py's (seeds 1 / 2, two scans, batch 4)."""
    scans, nodes, seeds, batch = ((1, 14, (11, 12), 2) if golden
                                  else (2, 20, (1, 2), 4))
    world, _ = world_fn(num_scans=scans, num_nodes=nodes,
                        max_candidates=cfg.env.max_candidates,
                        views=cfg.env.views, feat_dim=cfg.model.image_feat_size,
                        seed=seeds[0])
    ep = episodes_fn(world, batch=batch, max_gt_path_len=cfg.env.max_gt_path_len,
                     max_instr_len=cfg.env.max_instr_len,
                     max_imaginations=cfg.model.max_imagination_len,
                     vocab_size=cfg.model.vocab_size,
                     feat_dim=cfg.model.hidden_size, seed=seeds[1])
    return world, ep


def _with(cfg, part, **kw):
    return dataclasses.replace(
        cfg, **{part: dataclasses.replace(getattr(cfg, part), **kw)})


@pytest.fixture(scope="module")
def setup():
    jcfg = j_tiny_test_config("duet")
    jw, jep = (jax.tree.map(jnp.asarray, x)
               for x in _world_ep(j_world, j_episodes, jcfg))
    jtr = JDuetTrainer(jcfg, jw, rng=jax.random.PRNGKey(42))
    # DuetTrainer.init_state's params, traced under jit (faster than the
    # op-by-op init): the key it splits off, the first episode
    key, _ = jax.random.split(jax.random.PRNGKey(42))
    ep1 = jax.tree.map(lambda x: x[:1], jep)
    params = jax.jit(lambda r: j_trainer_duet._init_duet_params(
        jtr.model, jcfg, jw, ep1, r))(key)
    cfg = tiny_test_config("duet")
    world, ep = _world_ep(synthetic_world, synthetic_episodes, cfg)
    return jtr, jcfg, jw, jep, params, cfg, world.to("cpu"), ep.to("cpu")


def _port_model(params, cfg):
    model = DuetModel(cfg.model, feat_dropout=cfg.train.feat_dropout)
    model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, params), "duet"), strict=True)
    return model


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, np.asarray(v)


def _assert_grads(model, want_tree):
    """Every parameter's .grad (None counts as zero) against the JAX
    gradient tree, leaf by leaf, within 1e-4 relative to the element and
    to the leaf's largest element: at the init, rows of zeros meet a
    LayerNorm (padded map slots, zero biases), whose 1/sqrt(1e-12) makes
    summands of ~1e6 that cancel to elements of ~1e4, so f32 rounding of
    the summands sits far above 1e-4 of the sum.  Returns the port's
    gradient leaves."""
    got = flax_from_state_dict(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in model.named_parameters()}, "duet")
    got, want = dict(_leaves(got["params"])), dict(_leaves(want_tree["params"]))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=TOL,
                                   atol=TOL * max(1.0, np.abs(w).max()),
                                   err_msg=path)
    assert any(np.abs(w).max() > 0 for w in want.values())
    return got


def _assert_close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL, err_msg=what)


def test_greedy_eval_paths_match_jax():
    """tests/test_duet.py's world at batch 4, with the port's seeded init
    carried into the JAX package (under the JAX init every item stops at
    once; this one walks, teleports and backtracks)."""
    jcfg, cfg = j_tiny_test_config("duet"), tiny_test_config("duet")
    world, ep = _world_ep(synthetic_world, synthetic_episodes, cfg, golden=False)
    tr = DuetTrainer(cfg, world, device="cpu")
    paths, lens = tr.make_eval_step()(ep)
    jw, jep = (jax.tree.map(jnp.asarray, x)
               for x in _world_ep(j_world, j_episodes, jcfg, golden=False))
    jpaths, jlens = JDuetTrainer(jcfg, jw).make_eval_step()(
        flax_from_state_dict(tr.model.state_dict(), "duet"), jep,
        jax.random.PRNGKey(0))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(paths.numpy(), np.asarray(jpaths))
    assert (lens.numpy() > 2).sum() >= 3


def test_teacher_rollout_losses_logits_and_grads_match_jax(setup):
    jtr, jcfg, jw, jep, params, cfg, world, ep = setup
    model = _port_model(params, cfg)
    res = rollout_duet(model, world, ep, cfg, feedback="teacher", train_ml=1.0,
                       deterministic=True)
    res.loss.backward()

    def loss_fn(params):
        r = j_rollout(jtr.model, params, jw, jep, jcfg, jax.random.PRNGKey(7),
                      feedback="teacher", train_ml=1.0, deterministic=True)
        return r.loss, r

    (_, jres), jgrad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    np.testing.assert_array_equal(res.path_nodes.numpy(),
                                  np.asarray(jres.path_nodes))
    np.testing.assert_array_equal(res.path_len.numpy(),
                                  np.asarray(jres.path_len))
    np.testing.assert_array_equal(res.actions.numpy(), np.asarray(jres.actions))
    for name in ("loss", "ml_loss", "aux_loss", "logits"):
        _assert_close(getattr(res, name), getattr(jres, name), name)
    got = _assert_grads(model, jgrad)
    # the graph bias is trained through the attention's dBias (its bias
    # shifts whole score rows, to which the softmax is blind)
    assert np.abs(got["sprel_linear/kernel"]).max() > 1e-3


def test_sample_rollout_losses_and_grads_match_jax(setup, monkeypatch):
    """DAgger's student rollout: 'sample' feedback supervised by the SPL
    expert, both packages' sampling patched to argmax and every dropout
    off, so both take the same actions and must agree."""
    jtr, jcfg, jw, jep, params, cfg, world, ep = setup
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1, **kw:
                        jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(port_rollout, "sample_categorical",
                        lambda logp, generator: torch.argmax(logp, dim=-1))
    model = _port_model(params, cfg)
    res = rollout_duet(model, world, ep, cfg, rng=Rng(0, "cpu"),
                       feedback="sample", train_ml=1.0, deterministic=True)
    res.loss.backward()

    def loss_fn(params):
        r = j_rollout(jtr.model, params, jw, jep, jcfg, jax.random.PRNGKey(3),
                      feedback="sample", train_ml=1.0, deterministic=True)
        return r.loss, r

    (_, jres), jgrad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    np.testing.assert_array_equal(res.actions.numpy(), np.asarray(jres.actions))
    np.testing.assert_array_equal(res.path_nodes.numpy(),
                                  np.asarray(jres.path_nodes))
    assert float(res.ml_loss.detach()) > 0.0
    for name in ("loss", "ml_loss", "aux_loss", "entropy_sum", "logits"):
        _assert_close(getattr(res, name), getattr(jres, name), name)
    _assert_grads(model, jgrad)


def test_port_reproduces_goldens(setup):
    *_, params, cfg, world, ep = setup
    res = rollout_duet(_port_model(params, cfg), world, ep, cfg,
                       feedback="teacher", train_ml=1.0, deterministic=True)
    want = dict(np.load(GOLDEN))
    got = {"duet_ml_loss": res.ml_loss, "duet_aux_loss": res.aux_loss,
           "duet_logits_t0": res.logits[0], "duet_paths": res.path_nodes}
    for key, value in got.items():
        value = value.detach().numpy()
        if key.endswith("_paths"):
            np.testing.assert_array_equal(value, want[key], err_msg=key)
        else:
            np.testing.assert_allclose(value, want[key], rtol=GOLDEN_TOL,
                                       atol=GOLDEN_TOL, err_msg=key)


# ------------------------------------------------------------ train step
class _NoDropout(flax.linen.Module):
    """flax.linen.Dropout's signature, the identity."""
    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


def test_imitation_train_steps_match_jax(setup, monkeypatch):
    """Three 'imitation' steps with stage ends 1 and 2 (stage 1, the lagged
    stage 2, stage 3) from the JAX init.  The tiny config sets every
    configurable dropout to 0; the alignment head's fixed 0.15 dropout is
    taken out of both packages.  grad_norm and loss within 1e-4 relative;
    parameters within 1e-7 plus 1e-2 of the largest move so far, as
    tests/test_torch_train.py (Adam moves an element by ~lr * sign(g)
    whatever |g| is)."""
    jcfg = _with(j_tiny_test_config("duet"), "train", train_alg="imitation",
                 warmup_stage1_iters=1, warmup_stage2_iters=2)
    pcfg = _with(tiny_test_config("duet"), "train", train_alg="imitation",
                 warmup_stage1_iters=1, warmup_stage2_iters=2)
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    _, _, jw, jep, params, *_ = setup
    # the fixture's JAX init (PRNGKey(42)), without tracing the init again
    monkeypatch.setattr(j_trainer_duet, "_init_duet_params",
                        lambda *args: params)
    jtr = JDuetTrainer(jcfg, jw, rng=jax.random.PRNGKey(42))
    state = jtr.init_state(jep)
    jstep = jtr.make_train_step(donate=False)

    world, ep = _world_ep(synthetic_world, synthetic_episodes, pcfg)
    tr = DuetTrainer(pcfg, world, device="cpu")
    tr.model.contrastive_alignment_model.image_proj.rate = 0.0
    tr.model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, state.params), "duet"), strict=True)
    step = tr.make_train_step()
    init = dict(_leaves(state.params["params"]))

    for i in range(3):
        state, jm = jstep(state, jep, jep, jax.random.PRNGKey(i))
        m = step(ep, ep)
        for key in ("grad_norm", "loss", "ml_loss", "aux_loss"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=f"step {i} {key}")
        got = dict(_leaves(flax_from_state_dict(tr.model.state_dict(),
                                                "duet")["params"]))
        want = dict(_leaves(state.params["params"]))
        moved = max(np.abs(want[p] - init[p]).max() for p in want)
        for path in want:
            np.testing.assert_allclose(got[path], want[path], rtol=0,
                                       atol=1e-7 + 1e-2 * moved,
                                       err_msg=f"step {i} {path}")
        assert moved > 0


def _dagger_trainer(seed=0):
    cfg = tiny_test_config("duet")
    cfg = _with(cfg, "model", hidden_dropout_prob=0.1,
                attention_probs_dropout_prob=0.1)
    cfg = _with(cfg, "train", feat_dropout=0.4, warmup_stage1_iters=5,
                warmup_stage2_iters=10)
    world, ep = _world_ep(synthetic_world, synthetic_episodes, cfg)
    return DuetTrainer(cfg, world, device="cpu", seed=seed), ep


def test_dagger_train_step_with_dropout():
    runs = []
    for _ in range(2):
        tr, ep = _dagger_trainer()
        model0 = {k: v.clone() for k, v in tr.model.state_dict().items()}
        m = tr.make_train_step()(ep, ep)
        runs.append((m, tr.model.state_dict()))
        assert set(m) == {"loss", "ml_loss", "aux_loss", "dagger_loss",
                          "entropy", "grad_norm"}
        assert all(torch.isfinite(v) for v in m.values())
        assert m["grad_norm"] > 0 and m["dagger_loss"] > 0 and m["entropy"] > 0
        # stage 1: only the aux groups move
        for name, v in tr.model.state_dict().items():
            same = torch.equal(v, model0[name])
            assert same == (label_hamt_param(name) == "rest"), name
    (m1, p1), (m2, p2) = runs
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    # dropout is on: another seed takes other masks and actions
    tr, ep = _dagger_trainer(seed=1)
    assert tr.make_train_step()(ep, ep)["loss"] != m1["loss"]


@pytest.mark.parametrize("part,kw,call", [
    ("train", {"expl_sample": True}, "train"),
    ("train", {"train_alg": "rl", "gamma": 0.9}, "train"),
    ("train", {"expert_policy": "ndtw"}, "train"),
    ("train", {"act_visited_nodes": True}, "eval"),
    ("train", {"detailed_output": True}, "eval"),
    ("model", {"fusion": "local"}, "eval"),
])
def test_deferred_branches_run(part, kw, call):
    """The branches a later slice ported, through the same entry points:
    finite train metrics that move the weights, or greedy paths that start
    at the start node and move along edges (with `detailed_output`, a stop
    table of the nodes the item stood at: its start and end among them, and
    only nodes of its path).  Held against the JAX package in
    tests/test_torch_rollout_duet_variants.py."""
    cfg = _with(tiny_test_config("duet"), part, **kw)
    world, ep = _world_ep(synthetic_world, synthetic_episodes, cfg,
                          golden=False)
    tr = DuetTrainer(cfg, world, device="cpu")
    if call == "train":
        before = {k: v.clone() for k, v in tr.model.state_dict().items()}
        m = tr.make_train_step()(ep, ep)
        assert all(torch.isfinite(v) for v in m.values()), m
        assert m["grad_norm"] > 0
        assert ("rl_loss" in m) == (kw.get("train_alg") == "rl")
        assert any(not torch.equal(v, before[k])
                   for k, v in tr.model.state_dict().items())
        return
    detailed = cfg.train.detailed_output
    out = tr.make_eval_step(detailed=detailed)(ep)
    paths, lens = out[0].numpy(), out[1].numpy()
    adj = np.asarray(world.adj)
    for b in range(ep.batch):
        p = paths[b, :lens[b]]
        assert p[0] == ep.start_node[b]
        scan = int(ep.scan[b])
        assert all(n in adj[scan, a] for a, n in zip(p[:-1], p[1:])), p
        if detailed:  # the nodes it stood at: the start, the end, no other
            nodes, _, valid = (x[b].numpy() for x in out[2])
            table = set(nodes[valid].tolist())
            assert {p[0], p[-1]} <= table <= set(p.tolist())
    assert (lens > 1).any()


@pytest.mark.parametrize("part,kw,call", [
    ("model", {"obj_feat_size": 768}, "init"),
    ("model", {"e2e_imagination": "frozen"}, "init"),
    ("model", {"use_lang2visn_attn": True}, "init"),
])
def test_deferred_options_raise(part, kw, call):
    """What the port leaves for later raises where it is reached.  Objects
    (`obj_feat_size`, ROADMAP Queue 1 item 4) are ported: the model builds
    its grounding head and, on a world without objects, evaluates as R2R."""
    cfg = _with(tiny_test_config("duet"), part, **kw)
    world, ep = _world_ep(synthetic_world, synthetic_episodes, cfg)
    if kw.get("obj_feat_size"):
        tr = DuetTrainer(cfg, world, device="cpu")
        assert hasattr(tr.model, "og_head")
        assert hasattr(tr.model.img_embeddings, "obj_linear")  # 768 != 32
        paths, lens = tr.make_eval_step()(ep)
        assert (lens >= 1).all() and (paths[:, 0] == ep.to("cpu").start_node).all()
        return
    with pytest.raises(NotImplementedError):
        tr = DuetTrainer(cfg, world, device="cpu")
        if call == "train":
            tr.make_train_step()(ep, ep)
        else:
            tr.make_eval_step()(ep)
