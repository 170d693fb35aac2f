"""Train steps of the port on a model axis, on the CPU: gloo processes on
meshes of 1 x 2 and 2 x 2 (data x model), parameters of at least 2^10
elements split by `param_shardings` (each rank's attention on its own 2 of
the 4 heads, the kernels' dropout bits those of its heads), a global batch
of 4, against the step on the whole batch with whole parameters:

- From the JAX init, f32, every configurable dropout 0, every group
  training from the first step: the HAMT `teacher` step (cosine alignment)
  and the DUET `imitation` step against the JAX package's single-process
  step, metrics within 2e-4 and the updated parameters' abs-sum within
  2e-5 relative (the tolerances of `test_torch_dp_train.py` and of the JAX
  package's own `test_multihost.py`).
- Every train case of the data-parallel test (`_torch_dp.train_cases`: the
  teacher steps with the cosine, InfoNCE and margin losses, and with every
  dropout on the HAMT `sample` step, the fused rollout and the DUET DAgger
  step) against the port's one-process step: metrics within 1e-4 and the
  updated whole parameters' abs-sum within 2e-5 relative, the critic's
  parameters within 1e-4.
- The ranks end every step with the same metrics and whole parameters.
- `global_norm` and a ralamb step (per-parameter trust ratio) on the split
  model equal the whole model's.
- Each way a layer is split (a Dense on its output or its input axis, an
  Embed on its features or its rows) gives the whole layer's output, input
  gradient and parameter gradients.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dp import (
    DROPOUT_CASES,
    TEACHER_CASES,
    TRAIN_BATCH,
    finish,
    start,
    teacher_config,
    train_cases,
    world_and_episodes,
)
from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.envx import synthetic_episodes as j_episodes
from vln_imagine_tpu.envx import synthetic_world as j_world
from vln_imagine_tpu.train.trainer import HamtTrainer as JHamtTrainer
from vln_imagine_tpu.train.trainer_duet import DuetTrainer as JDuetTrainer
from vln_imagine_tpu_torch.ckpt.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)

torch.set_num_threads(2)

METRICS = ("grad_norm", "loss", "ml_loss", "aux_loss")
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
JAX_CASES = [("hamt", "cosine"), ("duet", "cosine")]


class _NoDropout(flax.linen.Module):
    """flax.linen.Dropout's signature, the identity."""
    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


def _abs_sum(tree) -> float:
    return float(sum(np.abs(np.asarray(x, np.float32)).sum()
                     for x in jax.tree.leaves(tree)))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """(rank results by mesh, the port's one-process steps, the JAX
    steps)."""
    out = tmp_path_factory.mktemp("tp_train")
    inits = {}
    for agent in ("hamt", "duet"):
        cfg = teacher_config(agent, tiny=j_tiny_test_config)
        world, _, ep = world_and_episodes(cfg, TRAIN_BATCH, world_fn=j_world,
                                          episodes_fn=j_episodes)
        world, ep = (jax.tree.map(jnp.asarray, x) for x in (world, ep))
        cls = JHamtTrainer if agent == "hamt" else JDuetTrainer
        state = cls(cfg, world, rng=jax.random.PRNGKey(42)).init_state(ep)
        sd = state_dict_from_flax(jax.tree.map(np.asarray, state.params),
                                  agent)
        for name in MESHES:
            (out / name).mkdir(exist_ok=True)
            torch.save(sd, out / name / f"{agent}_init.pt")
        inits[agent] = (world, ep, state)
    procs = {name: start("tp_train", out / name, world=d * m, model=m)
             for name, (d, m) in MESHES.items()}
    want_jax = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax.linen, "Dropout", _NoDropout)
            for agent, aux in JAX_CASES:
                world, ep, state = inits[agent]
                cfg = teacher_config(agent, aux, tiny=j_tiny_test_config)
                jtr = (JHamtTrainer if agent == "hamt" else JDuetTrainer)(
                    cfg, world)
                jtr.tx = jtr._tx_builder(state.params)  # no second init
                step = (jtr.make_train_step("teacher", donate=False)
                        if agent == "hamt" else
                        jtr.make_train_step(donate=False))
                new, m = step(state, ep, ep, jax.random.PRNGKey(0))
                want_jax[f"{agent}_{aux}"] = (
                    {k: float(m[k]) for k in METRICS},
                    _abs_sum(new.params["params"]))
        one = train_cases(None, out / "1x2")
    except BaseException:
        for ps in procs.values():
            for p in ps:
                p.kill()
                p.wait()
        raise
    ranks = {name: finish(procs[name], "tp_train", out / name, timeout=400)
             for name in MESHES}
    return ranks, one, want_jax


def _param_sum(case: str, model_sd) -> float:
    return _abs_sum(flax_from_state_dict(model_sd, case.split("_")[0])["params"])


ALL_IDS = [f"{a}_{x}" for a, x in TEACHER_CASES] + list(DROPOUT_CASES)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", [f"{a}_{x}" for a, x in JAX_CASES])
def test_tp_step_matches_the_jax_step(steps, case, mesh):
    ranks, _, want_jax = steps
    got = ranks[mesh][0][case]
    want_m, want_sum = want_jax[case]
    for k in METRICS:
        np.testing.assert_allclose(got["metrics"][k], want_m[k], rtol=2e-4,
                                   atol=2e-4, err_msg=k)
    np.testing.assert_allclose(_param_sum(case, got["model"]), want_sum,
                               rtol=2e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", ALL_IDS)
def test_tp_step_matches_one_process(steps, case, mesh):
    ranks, one, _ = steps
    got, want = ranks[mesh][0][case], one[case]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert got["model"].keys() == want["model"].keys()
    for k, v in want["model"].items():
        assert got["model"][k].shape == v.shape, k
    np.testing.assert_allclose(_param_sum(case, got["model"]),
                               _param_sum(case, want["model"]), rtol=2e-5)
    if "critic" in want:
        for k, v in want["critic"].items():
            torch.testing.assert_close(got["critic"][k], v, rtol=1e-4,
                                       atol=1e-6)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_ranks_end_each_step_in_the_same_state(steps, mesh):
    r0, *rest = steps[0][mesh]
    assert set(r0) == set(ALL_IDS) | {"norms", "layers"}
    for r in rest:
        for case in ALL_IDS:
            assert r0[case]["metrics"] == r[case]["metrics"], case
            for part in ("model", "critic"):
                for k, v in r0[case].get(part, {}).items():
                    assert torch.equal(v, r[case][part][k]), (case, k)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_global_norm_and_trust_ratio_on_shards_equal_the_whole(steps, mesh):
    norms = steps[0][mesh][0]["norms"]
    assert norms["n_split"] > 0
    np.testing.assert_allclose(norms["norm"][1], norms["norm"][0], rtol=1e-6)
    whole, split = norms["ralamb"]
    assert whole.keys() == split.keys()
    for k, v in whole.items():
        torch.testing.assert_close(split[k], v, rtol=1e-5, atol=1e-7)


LAYERS = ["dense_output", "dense_input", "embed_features", "embed_rows"]


@pytest.mark.parametrize("layer", LAYERS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_way_a_layer_is_split_matches_the_whole_layer(steps, mesh,
                                                           layer):
    for rank in steps[0][mesh]:
        case = rank["layers"][layer]
        assert case["split"]
        whole, split = case["y"]
        torch.testing.assert_close(split, whole, rtol=1e-6, atol=1e-6)
        if case["x_grad"][0] is not None:
            torch.testing.assert_close(case["x_grad"][1], case["x_grad"][0],
                                       rtol=1e-6, atol=1e-6)
        gw, gs = case["grads"]
        assert gw.keys() == gs.keys()
        for k, v in gw.items():
            torch.testing.assert_close(gs[k], v, rtol=1e-6, atol=1e-6)
