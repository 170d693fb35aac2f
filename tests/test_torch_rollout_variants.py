"""The task variants' rollouts and train steps in the port against the JAX
package, on the CPU in f32 at the tiny config, every dropout off.  This
file: r2r_back and CVDN on HAMT, and the helpers that
tests/test_torch_rollout_navref.py (REVERIE on HAMT) and
tests/test_torch_rollout_reverie_duet.py (REVERIE on DUET) share.

- r2r_back: the teacher declares the midstop and returns along the
  out-and-back path; a sampled item that stops goes on after its first
  stop (RL rewards target the midstop, then the goal); greedy eval returns
  the declared midstop; one `make_train_step("sample")` step;
- CVDN: the shortest-path teacher, walked over `max_action_len` steps, and
  one `make_train_step("teacher")` step, whose IL rollout runs as long.

Actions, paths, `midstop` and `pred_obj` are identical; losses, logits and
gradients within 1e-4 (relative to the gradient leaf's largest element),
as tests/test_torch_rollout_train.py; after a train step every parameter
within 1e-2 of the largest step, as tests/test_torch_hamt_variants.py.
NavRef runs the JAX package's init (PRNGKey 42) carried into the port by
the bridge; the others the port's seeded init carried into the JAX package
(under the JAX init every r2r_back item stops at once).  Sampling is
patched to the same rule in both packages: the stop action where it is
within STOP_MARGIN of the best log-probability, else the argmax, so that
sampled r2r_back items stop early and go on.
"""

import dataclasses
import re
from types import SimpleNamespace

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_imagine_tpu.config import _replace as j_replace
from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.envx import synthetic_episodes as j_episodes
from vln_imagine_tpu.envx import synthetic_world as j_world
from vln_imagine_tpu.train.rollout_hamt import rollout_hamt as j_rollout_hamt
from vln_imagine_tpu.train import trainer as j_trainer
from vln_imagine_tpu.train import trainer_duet as j_trainer_duet
from vln_imagine_tpu.train.trainer import HamtTrainer as JHamtTrainer
from vln_imagine_tpu.train.trainer_duet import DuetTrainer as JDuetTrainer
from vln_imagine_tpu_torch.ckpt.convert import (
    critic_flax_from_state_dict,
    critic_state_dict_from_flax,
    flax_from_state_dict,
    state_dict_from_flax,
)
from vln_imagine_tpu_torch.config import _replace, tiny_test_config
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.envx.compiler import shortest_path_nodes
from vln_imagine_tpu_torch.models.bert import Critic
from vln_imagine_tpu_torch.models.hamt import HamtModel
from vln_imagine_tpu_torch.ops.dropout import Rng
from vln_imagine_tpu_torch.train import rollout_duet as port_rollout_duet
from vln_imagine_tpu_torch.train import rollout_hamt as port_rollout
from vln_imagine_tpu_torch.train.rollout_hamt import rollout_hamt
from vln_imagine_tpu_torch.train.trainer import HamtTrainer
from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

torch.set_num_threads(2)

TOL = 1e-4
STOP_MARGIN = 0.6
KO, DO = 3, 32

NAVREF = dict(obj_feat_size=DO, imagine_enc_pano=False,
              use_cosine_aux_loss=False, no_lang_ca=True,
              act_pred_token="ob_hist")
# variant -> (agent, dataset, model overrides, objects in the world)
SETUPS = {
    "reverie_hamt": ("hamt", "reverie", NAVREF, True),
    "r2r_back": ("hamt", "r2r_back", {}, False),
    "cvdn": ("hamt", "cvdn", {}, False),
    "reverie_duet": ("duet", "reverie", dict(obj_feat_size=DO), True),
}


def _cfgs(variant):
    agent, dataset, model, _ = SETUPS[variant]
    return tuple(
        dataclasses.replace(rep(tiny(agent), "model", **model),
                            dataset=dataset)
        for tiny, rep in ((j_tiny_test_config, j_replace),
                          (tiny_test_config, _replace)))


def out_and_back(ep):
    """r2r_back episodes: start -> goal -> start, midstop = the old goal
    (tests/test_r2r_back.py)."""
    gt_path, gt_len = np.asarray(ep.gt_path), np.asarray(ep.gt_len)
    P = gt_path.shape[1]
    paths, lens, mids = [], [], []
    for b in range(ep.batch):
        fwd = list(gt_path[b, :gt_len[b]])
        back = (fwd + fwd[-2::-1])[:P]
        mids.append(fwd[-1])
        lens.append(len(back))
        paths.append(back + [back[-1]] * (P - len(back)))
    return ep.replace(gt_path=np.asarray(paths, np.int32),
                      gt_len=np.asarray(lens, np.int32),
                      midstop=np.asarray(mids, np.int32))


def _world_ep(world_fn, episodes_fn, cfg, variant):
    objects = SETUPS[variant][3]
    world, graphs = world_fn(
        num_scans=1, num_nodes=16, max_candidates=cfg.env.max_candidates,
        views=cfg.env.views, feat_dim=cfg.model.image_feat_size, seed=5,
        **(dict(max_objects=KO, obj_feat_dim=DO) if objects else {}))
    ep = episodes_fn(world, batch=3, max_gt_path_len=cfg.env.max_gt_path_len,
                     max_instr_len=cfg.env.max_instr_len,
                     max_imaginations=cfg.model.max_imagination_len,
                     vocab_size=cfg.model.vocab_size,
                     feat_dim=cfg.model.hidden_size, seed=6,
                     min_hops=1 if variant == "r2r_back" else 2)
    if variant == "r2r_back":
        ep = out_and_back(ep)
    return world, graphs, ep


class _Setups(dict):
    """variant -> (JAX config, port config, JAX trainer, the weights
    (params, critic_params; None for DUET), JAX world, JAX episodes, port
    world, port episodes, host graphs), built at first use."""

    def __missing__(self, variant):
        jcfg, cfg = _cfgs(variant)
        jw, graphs, jep = _world_ep(j_world, j_episodes, jcfg, variant)
        jw, jep = (jax.tree.map(jnp.asarray, x) for x in (jw, jep))
        w, _, ep = _world_ep(synthetic_world, synthetic_episodes, cfg, variant)
        if variant == "reverie_hamt":
            jtr = JHamtTrainer(jcfg, jw, rng=jax.random.PRNGKey(42))
            state = jtr.init_state(jep)
        elif SETUPS[variant][0] == "hamt":
            # the port's seeded init: under it sampled items stop and go on
            tr = HamtTrainer(cfg, w, device="cpu")
            jtr = JHamtTrainer(jcfg, jw)
            state = SimpleNamespace(
                params=flax_from_state_dict(tr.model.state_dict()),
                critic_params=critic_flax_from_state_dict(
                    tr.critic.state_dict()))
        else:
            jtr, state = JDuetTrainer(jcfg, jw), None
        self[variant] = (jcfg, cfg, jtr, state, jw, jep, w.to("cpu"),
                         ep.to("cpu"), graphs)
        return self[variant]


@pytest.fixture(scope="module")
def setups():
    return _Setups()


def _j_stop_or_best(logp, stop_slot):
    """The stop slot where its log-probability is within STOP_MARGIN of the
    best, else the argmax."""
    near = logp[:, stop_slot] >= jnp.max(logp, axis=-1) - STOP_MARGIN
    return jnp.where(near, stop_slot, jnp.argmax(logp, axis=-1))


def _stop_or_best(logp, stop_slot):
    near = logp[:, stop_slot] >= logp.amax(dim=-1) - STOP_MARGIN
    return torch.where(near, stop_slot, torch.argmax(logp, dim=-1))


@pytest.fixture
def same_draws(monkeypatch):
    """The HAMT stop slot is K = max_candidates (7 at the tiny config); DUET
    patches only the plain argmax (its stop is index 0 and its sampled
    stop away from the goal ends the episode)."""
    K = tiny_test_config("hamt").env.max_candidates
    state = {"stop": K}
    monkeypatch.setattr(
        jax.random, "categorical", lambda key, logits, axis=-1, **kw:
        _j_stop_or_best(logits, state["stop"]) if state["stop"] is not None
        else jnp.argmax(logits, axis=axis))
    for module in (port_rollout, port_rollout_duet):
        monkeypatch.setattr(
            module, "sample_categorical", lambda logp, generator:
            _stop_or_best(logp, state["stop"]) if state["stop"] is not None
            else torch.argmax(logp, dim=-1))
    return state


def _hamt_modules(state, cfg):
    model = HamtModel(cfg.model, feat_dropout=cfg.train.feat_dropout)
    result = model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, state.params)), strict=False)
    # NavRef's x-layer language branches: never applied, no flax params
    assert all(re.fullmatch(r"encoder\.x_layers\.\d+\.lang_.*", k)
               for k in result.missing_keys), result.missing_keys
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
    gradient tree; a parameter the JAX model lacks gets no gradient."""
    got = to_flax({n: (p.grad if p.grad is not None else torch.zeros_like(p))
                   for n, p in module.named_parameters()})
    got, want = dict(_leaves(got["params"])), dict(_leaves(want_tree["params"]))
    assert set(want) <= set(got), what
    for path in set(got) - set(want):
        assert not np.any(got[path]), f"{what} {path}"
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=TOL,
                                   atol=TOL * max(1.0, np.abs(w).max()),
                                   err_msg=f"{what} {path}")
    assert any(np.abs(w).max() > 0 for w in want.values()), what


def _close(got, want, what):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(),
                               np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=what)


def _run_hamt(setups, variant, feedback, train_ml, train_rl):
    jcfg, cfg, jtr, state, jw, jep, w, ep, _ = setups[variant]
    model, critic = _hamt_modules(state, cfg)
    training = train_ml is not None or train_rl
    res = rollout_hamt(model, w, ep, cfg, rng=Rng(0, "cpu"), critic=critic,
                       feedback=feedback, train_ml=train_ml,
                       train_rl=train_rl, deterministic=True)
    if training:
        res.loss.backward()

    def loss_fn(params, critic_params):
        r = j_rollout_hamt(jtr.model, jtr.critic, params, critic_params, jw,
                           jep, jcfg, jax.random.PRNGKey(3),
                           feedback=feedback, train_ml=train_ml,
                           train_rl=train_rl, deterministic=True)
        return r.loss, r

    if training:
        (_, jres), (jg, jgc) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(state.params,
                                                   state.critic_params)
    else:
        _, jres = loss_fn(state.params, state.critic_params)
    np.testing.assert_array_equal(res.path_len.numpy(),
                                  np.asarray(jres.path_len))
    np.testing.assert_array_equal(res.path_nodes.numpy(),
                                  np.asarray(jres.path_nodes))
    np.testing.assert_array_equal(res.midstop.numpy(), np.asarray(jres.midstop))
    np.testing.assert_array_equal(res.pred_obj.numpy(),
                                  np.asarray(jres.pred_obj))
    for name in ("loss", "ml_loss", "rl_loss", "aux_loss", "og_loss"):
        _close(getattr(res, name), getattr(jres, name), name)
    if training:
        np.testing.assert_array_equal(res.actions.numpy(),
                                      np.asarray(jres.actions))
        _close(res.logits, jres.logits, "logits")
        _assert_grads(model, jg, flax_from_state_dict, "model grad")
        if train_rl:
            _assert_grads(critic, jgc, critic_flax_from_state_dict,
                          "critic grad")
    return res, jres


# --------------------------------------------------------------- r2r_back
def test_r2r_back_teacher_declares_the_midstop_and_returns(setups,
                                                           same_draws):
    res, _ = _run_hamt(setups, "r2r_back", "teacher", 1.0, False)
    ep = setups["r2r_back"][7]
    pn, gt, gl = res.path_nodes.numpy(), ep.gt_path.numpy(), ep.gt_len.numpy()
    for b in range(ep.batch):
        np.testing.assert_array_equal(pn[b, :gl[b]], gt[b, :gl[b]])
    # declared at the teacher's first stop, the end of the out-and-back path
    assert (res.midstop.numpy() >= 0).all()


def test_r2r_back_sampled_items_go_on_after_the_first_stop(setups,
                                                           same_draws):
    res, _ = _run_hamt(setups, "r2r_back", "sample", None, True)
    mid, acts = res.midstop.numpy(), res.actions.numpy()
    stop = setups["r2r_back"][1].env.max_candidates
    pl = res.path_len.numpy()
    # an item that first stops at step s has made s moves; it went on if
    # its path grew past them
    went_on = [b for b in range(acts.shape[1]) if mid[b] >= 0
               and pl[b] > np.argmax(acts[:, b] == stop) + 1]
    assert went_on, "no sampled item moved after its first stop"
    pn, pl = res.path_nodes.numpy(), res.path_len.numpy()
    for b in range(acts.shape[1]):
        if mid[b] >= 0:
            assert mid[b] in pn[b, :pl[b]]


def test_r2r_back_eval_returns_the_midstop(setups, same_draws):
    jcfg, cfg, jtr, state, jw, jep, w, ep, _ = setups["r2r_back"]
    model, _ = _hamt_modules(state, cfg)
    from vln_imagine_tpu_torch.train.rollout_hamt import make_eval_fn
    paths, lens, mids = make_eval_fn(model, w, cfg, device="cpu")(ep)
    jpaths, jlens, jmids = jtr.make_eval_step()(state.params, jep,
                                                jax.random.PRNGKey(0))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(paths.numpy(), np.asarray(jpaths))
    np.testing.assert_array_equal(mids.numpy(), np.asarray(jmids))


# ------------------------------------------------------------------- cvdn
def test_cvdn_shortest_teacher_over_max_action_len(setups, same_draws):
    jcfg, cfg, jtr, state, jw, jep, w, ep, graphs = setups["cvdn"]
    res, _ = _run_hamt(setups, "cvdn", "teacher", 1.0, False)
    assert res.actions.shape[0] == cfg.env.max_action_len
    # the teacher walks the shortest path to the goal, then stops
    pn, pl = res.path_nodes.numpy(), res.path_len.numpy()
    for b in range(ep.batch):
        start, goal = int(ep.start_node[b]), int(ep.goal[b])
        want = shortest_path_nodes(graphs[int(ep.scan[b])], start, goal)
        assert pn[b, :pl[b]].tolist() == want


# -------------------------------------------------------------- train steps
class _NoDropout(flax.linen.Module):
    """flax.linen.Dropout's signature, the identity."""
    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


def _with(cfg, part, **kw):
    return dataclasses.replace(
        cfg, **{part: dataclasses.replace(getattr(cfg, part), **kw)})


def assert_step_matches_jax(setups, variant, monkeypatch, feedback=None):
    """One step of the variant's trainer from the same weights, every
    dropout off (`feedback` for HAMT; DUET runs its train_alg): the JAX
    step's metrics, and every model (and critic) parameter within 1e-2 of
    the largest step.  The warm-up's stage 1 ends at once, so that every
    group moves."""
    jcfg, cfg, jtr, state, jw, jep, w, ep, _ = setups[variant]
    agent = SETUPS[variant][0]
    jcfg, cfg = (_with(c, "train", warmup_stage1_iters=0,
                       warmup_stage2_iters=2) for c in (jcfg, cfg))
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    if agent == "hamt":
        params = jax.tree.map(np.copy, state.params)
        cparams = jax.tree.map(np.copy, state.critic_params)
        monkeypatch.setattr(j_trainer, "_init_params", lambda *a: params)
        jtr = JHamtTrainer(jcfg, jw, rng=jax.random.PRNGKey(42))
        jstate = jtr.init_state(jep)
        jstate = jstate.replace(critic_params=cparams,
                                critic_opt_state=jtr.critic_tx.init(cparams))
        jstep = jtr.make_train_step(feedback, donate=False)
        tr = HamtTrainer(cfg, w, device="cpu")
        model, critic = _hamt_modules(state, cfg)
        tr.model.load_state_dict(model.state_dict())
        tr.critic.load_state_dict(critic.state_dict())
        tr.critic.rate = 0.0
        step = tr.make_train_step(feedback)
        to_flax = flax_from_state_dict
    else:
        tr = DuetTrainer(cfg, w, device="cpu")
        params = jax.tree.map(np.copy, flax_from_state_dict(
            tr.model.state_dict(), "duet"))
        monkeypatch.setattr(j_trainer_duet, "_init_duet_params",
                            lambda *a: params)
        jtr = JDuetTrainer(jcfg, jw, rng=jax.random.PRNGKey(42))
        jstate = jtr.init_state(jep)
        jstep = jtr.make_train_step(donate=False)
        step = tr.make_train_step()

        def to_flax(sd):
            return flax_from_state_dict(sd, "duet")
    if hasattr(tr.model, "contrastive_alignment_model"):
        tr.model.contrastive_alignment_model.image_proj.rate = 0.0
    jstate, jm = jax.block_until_ready(jstep(jstate, jep, jep,
                                             jax.random.PRNGKey(0)))
    m = step(ep, ep)
    for key in jm:
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    assert float(m["grad_norm"]) > 0
    init = dict(_leaves(params["params"]))
    got = dict(_leaves(to_flax(tr.model.state_dict())["params"]))
    want = dict(_leaves(jstate.params["params"]))
    moved = max(np.abs(want[p] - init[p]).max() for p in want)
    assert moved > 0
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=1e-7 + 1e-2 * moved, err_msg=path)
    if agent == "hamt":
        gotc = dict(_leaves(critic_flax_from_state_dict(
            tr.critic.state_dict())["params"]))
        for path, wc in _leaves(jstate.critic_params["params"]):
            np.testing.assert_allclose(gotc[path], wc, rtol=0, atol=1e-5,
                                       err_msg=path)
    return m, jm


@pytest.mark.parametrize("variant, feedback", [("r2r_back", "sample"),
                                               ("cvdn", "teacher")])
def test_train_step_matches_jax(setups, same_draws, monkeypatch, variant,
                                feedback):
    assert_step_matches_jax(setups, variant, monkeypatch, feedback)
