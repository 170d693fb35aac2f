"""The port's compiled world and env functions against the JAX package's:
synthetic tables equal field by field, and observe / history / step agree
along a fixed action sequence that includes stop and the clipped -1 slot."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_imagine_tpu.config import hamt_r2r_config as j_hamt_r2r_config
from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.envx import env as jenv
from vln_imagine_tpu.envx import synthetic_episodes as j_episodes
from vln_imagine_tpu.envx import synthetic_world as j_world
from vln_imagine_tpu_torch.config import hamt_r2r_config, tiny_test_config
from vln_imagine_tpu_torch.envx import env as penv
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world

torch.set_num_threads(2)

FLOAT_TOL = 1e-6  # sin/cos of f32 angles on two CPU math libraries


def _golden(world_fn, episodes_fn, cfg):
    """tests/test_golden.py's world and episodes (seeds 11 / 12)."""
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


def _bench(world_fn, episodes_fn, cfg):
    """bench.py's full-width world and episodes (seeds 0 / 1, batch 8)."""
    world, _ = world_fn(num_scans=2, num_nodes=96,
                        max_candidates=cfg.env.max_candidates, views=36,
                        feat_dim=cfg.model.image_feat_size, seed=0)
    ep = episodes_fn(world, batch=8, max_gt_path_len=cfg.env.max_gt_path_len,
                     max_instr_len=cfg.env.max_instr_len,
                     max_imaginations=cfg.model.max_imagination_len,
                     vocab_size=cfg.model.vocab_size,
                     feat_dim=cfg.model.hidden_size, seed=1)
    return world, ep


def _assert_same_fields(port, ref):
    names = [f.name for f in dataclasses.fields(port)]
    assert names == [n for n in (f.name for f in dataclasses.fields(ref))
                     if n in names]
    for f in dataclasses.fields(ref):
        if f.name not in names:
            assert getattr(ref, f.name) is None, f.name  # object/image fields
            continue
        a, b = np.asarray(getattr(port, f.name)), np.asarray(getattr(ref, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("which", ["golden", "bench"])
def test_synthetic_tables_equal_jax(which):
    build = _golden if which == "golden" else _bench
    jcfg = j_tiny_test_config("hamt") if which == "golden" else j_hamt_r2r_config()
    pcfg = tiny_test_config("hamt") if which == "golden" else hamt_r2r_config()
    jw, jep = build(j_world, j_episodes, jcfg)
    pw, pep = build(synthetic_world, synthetic_episodes, pcfg)
    _assert_same_fields(pw, jw)
    _assert_same_fields(pep, jep)


def _cmp(port, ref, what):
    a = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    b = np.asarray(ref)
    assert a.shape == b.shape, what
    if np.issubdtype(b.dtype, np.floating):
        np.testing.assert_allclose(a, b, rtol=FLOAT_TOL, atol=FLOAT_TOL,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def test_env_steps_match_jax():
    cfg = tiny_test_config("hamt")
    world, _ = synthetic_world(num_scans=2, num_nodes=20,
                               max_candidates=cfg.env.max_candidates,
                               views=cfg.env.views,
                               feat_dim=cfg.model.image_feat_size, seed=7)
    ep = synthetic_episodes(world, batch=6, max_gt_path_len=cfg.env.max_gt_path_len,
                            max_instr_len=cfg.env.max_instr_len,
                            max_imaginations=cfg.model.max_imagination_len,
                            vocab_size=cfg.model.vocab_size,
                            feat_dim=cfg.model.hidden_size, seed=8)
    jw = jax.tree.map(jnp.asarray, j_world(
        num_scans=2, num_nodes=20, max_candidates=cfg.env.max_candidates,
        views=cfg.env.views, feat_dim=cfg.model.image_feat_size, seed=7)[0])
    jep = jax.tree.map(jnp.asarray, j_episodes(
        jax.tree.map(np.asarray, jw), batch=6,
        max_gt_path_len=cfg.env.max_gt_path_len,
        max_instr_len=cfg.env.max_instr_len,
        max_imaginations=cfg.model.max_imagination_len,
        vocab_size=cfg.model.vocab_size, feat_dim=cfg.model.hidden_size, seed=8))
    pw, pep = world.to("cpu"), ep.to("cpu")
    K, T, A = cfg.env.max_candidates, cfg.env.max_action_len, cfg.model.angle_feat_size

    # per step, per item: a candidate slot (valid or not), -1 or K (stop)
    rng = np.random.default_rng(3)
    actions = rng.integers(-1, K + 1, size=(T, ep.batch)).astype(np.int32)
    actions[0, :3] = [0, 1, 2]     # early moves before items stop
    actions[1, 0] = -1             # the clipped -1 slot
    actions[2, 1] = K              # stop

    jst, pst = jenv.reset(jw, jep, T), penv.reset(pw, pep, T)
    for t in range(T):
        jobs = jenv.observe_hamt(jw, jep, jst, A)
        pobs = penv.observe_hamt(pw, pep, pst, A)
        for name in ("img", "ang", "nav_types", "valid", "cand_valid"):
            _cmp(getattr(pobs, name), getattr(jobs, name), f"t{t} obs.{name}")
        assert pobs.stop_slot == jobs.stop_slot
        a = actions[t]
        jhist = jenv.history_inputs(jw, jep, jst, jnp.asarray(a), A)
        phist = penv.history_inputs(pw, pep, pst, torch.from_numpy(a), A)
        for i, (p, j) in enumerate(zip(phist, jhist)):
            _cmp(p, j, f"t{t} history_inputs[{i}]")
        jst = jenv.step_hamt(jw, jep, jst, jnp.asarray(a))
        pst = penv.step_hamt(pw, pep, pst, torch.from_numpy(a))
        for name in ("node", "view_index", "ended", "path_nodes", "path_len"):
            _cmp(getattr(pst, name), getattr(jst, name), f"t{t} state.{name}")
        _cmp(penv.distance_to_goal(pw, pep, pst.node),
             jenv.distance_to_goal(jw, jep, jst.node), f"t{t} distance")
    assert pst.ended.any() and (pst.path_len > 1).any()


def test_teacher_and_dtw_match_jax():
    """teacher_hamt and the incremental DTW row (dtw_init / dtw_push /
    dtw_ndtw) against the JAX package's, step by step along one action
    sequence that follows the teacher for some items and strays for others."""
    cfg = tiny_test_config("hamt")
    world, _ = synthetic_world(num_scans=2, num_nodes=20,
                               max_candidates=cfg.env.max_candidates,
                               views=cfg.env.views,
                               feat_dim=cfg.model.image_feat_size, seed=5)
    ep = synthetic_episodes(world, batch=6, max_gt_path_len=cfg.env.max_gt_path_len,
                            max_instr_len=cfg.env.max_instr_len,
                            max_imaginations=cfg.model.max_imagination_len,
                            vocab_size=cfg.model.vocab_size,
                            feat_dim=cfg.model.hidden_size, seed=6)
    jw_np = j_world(num_scans=2, num_nodes=20,
                    max_candidates=cfg.env.max_candidates, views=cfg.env.views,
                    feat_dim=cfg.model.image_feat_size, seed=5)[0]
    jw = jax.tree.map(jnp.asarray, jw_np)
    jep = jax.tree.map(jnp.asarray, j_episodes(
        jw_np, batch=6, max_gt_path_len=cfg.env.max_gt_path_len,
        max_instr_len=cfg.env.max_instr_len,
        max_imaginations=cfg.model.max_imagination_len,
        vocab_size=cfg.model.vocab_size, feat_dim=cfg.model.hidden_size, seed=6))
    pw, pep = world.to("cpu"), ep.to("cpu")
    K, T = cfg.env.max_candidates, cfg.env.max_action_len
    ignore = cfg.train.ignoreid
    rng = np.random.default_rng(4)
    stray = rng.integers(0, K + 1, size=(T, ep.batch)).astype(np.int32)

    jst, pst = jenv.reset(jw, jep, T), penv.reset(pw, pep, T)
    jrow, prow = jenv.dtw_init(jw, jep), penv.dtw_init(pw, pep)
    _cmp(prow, jrow, "dtw_init")
    for t in range(T):
        jt = jenv.teacher_hamt(jw, jep, jst, t, ignore)
        pt = penv.teacher_hamt(pw, pep, pst, t, ignore)
        _cmp(pt, jt, f"t{t} teacher")
        # items 0-2 follow the teacher, the rest stray
        a = np.where(np.arange(ep.batch) < 3, pt.numpy(), stray[t])
        a = np.where(a == ignore, K, a).astype(np.int32)
        jst = jenv.step_hamt(jw, jep, jst, jnp.asarray(a))
        pst = penv.step_hamt(pw, pep, pst, torch.from_numpy(a))
        jrow = jenv.dtw_push(jw, jep, jrow, jst.node)
        prow = penv.dtw_push(pw, pep, prow, pst.node)
        _cmp(prow, jrow, f"t{t} dtw row")
        _cmp(penv.dtw_ndtw(prow, pep, cfg.env.error_margin),
             jenv.dtw_ndtw(jrow, jep, cfg.env.error_margin), f"t{t} ndtw")
    assert pst.ended.all() and (pst.path_len > 1).any()
