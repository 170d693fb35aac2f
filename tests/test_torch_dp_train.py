"""Data-parallel train steps of the port on the CPU: two gloo processes, each
with its two rows of a global batch of 4, against the step on the whole
batch.

- From the JAX init, f32, every configurable dropout 0 (the alignment
  head's fixed dropout taken out of both packages), every group training
  from the first step: the HAMT `teacher` step with the cosine, InfoNCE
  and margin alignment losses (whose negatives cross the ranks) and the
  DUET `imitation` step, against the JAX package's single-process step:
  metrics within 2e-4 and the updated parameters' abs-sum within 2e-5
  relative, the tolerances of the JAX package's own
  `test_multihost.py::test_two_process_data_parallel_train_step`.
- With every dropout on, attention dropout through the plain Philox
  version keyed by global batch row: the HAMT `sample` step (IL + RL, and
  as the fused rollout, whose IL and RL halves are two global batches side
  by side) and the DUET DAgger step, and the four steps above, against the
  port's
  one-process step: metrics within 1e-4 relative and the parameter sum
  within 2e-5 relative.  A rank drawing its own rows' masks instead of the
  global batch's moves these by whole percent.
- Both ranks end every step with the same metrics and parameters, bit for
  bit.
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


class _NoDropout(flax.linen.Module):
    """flax.linen.Dropout's signature, the identity."""
    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


def _abs_sum(tree) -> float:
    return float(sum(np.abs(np.asarray(x, np.float32)).sum()
                     for x in jax.tree.leaves(tree)))


def _jax_steps(out_dir):
    """The JAX package's single-process step of every teacher case from its
    init (written for the ranks as port state dicts first); returns
    {case: (metrics, parameter abs-sum)} and the started ranks."""
    inits, procs = {}, None
    for agent in ("hamt", "duet"):
        cfg = teacher_config(agent, tiny=j_tiny_test_config)
        world, _, ep = world_and_episodes(cfg, TRAIN_BATCH, world_fn=j_world,
                                          episodes_fn=j_episodes)
        world, ep = (jax.tree.map(jnp.asarray, x) for x in (world, ep))
        cls = JHamtTrainer if agent == "hamt" else JDuetTrainer
        state = cls(cfg, world, rng=jax.random.PRNGKey(42)).init_state(ep)
        torch.save(state_dict_from_flax(jax.tree.map(np.asarray, state.params),
                                        agent), out_dir / f"{agent}_init.pt")
        inits[agent] = (world, ep, state)
    procs = start("train", out_dir)  # the ranks run beside the JAX steps
    want = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax.linen, "Dropout", _NoDropout)
            for agent, aux in TEACHER_CASES:
                world, ep, state = inits[agent]
                cfg = teacher_config(agent, aux, tiny=j_tiny_test_config)
                jtr = (JHamtTrainer if agent == "hamt" else JDuetTrainer)(
                    cfg, world)
                jtr.tx = jtr._tx_builder(state.params)  # no second init
                step = (jtr.make_train_step("teacher", donate=False)
                        if agent == "hamt" else
                        jtr.make_train_step(donate=False))
                new, m = step(state, ep, ep, jax.random.PRNGKey(0))
                want[f"{agent}_{aux}"] = (
                    {k: float(m[k]) for k in METRICS},
                    _abs_sum(new.params["params"]))
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    return want, procs


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_train")
    want_jax, procs = _jax_steps(out)
    one = train_cases(None, out)
    ranks = finish(procs, "train", out, timeout=400)
    return ranks, one, want_jax


def _param_sum(case: str, model_sd) -> float:
    return _abs_sum(flax_from_state_dict(model_sd, case.split("_")[0])["params"])


TEACHER_IDS = [f"{a}_{x}" for a, x in TEACHER_CASES]
ALL_IDS = TEACHER_IDS + list(DROPOUT_CASES)


@pytest.mark.parametrize("case", TEACHER_IDS)
def test_two_rank_step_matches_the_jax_step(steps, case):
    ranks, _, want_jax = steps
    got = ranks[0][case]
    want_m, want_sum = want_jax[case]
    for k in METRICS:
        np.testing.assert_allclose(got["metrics"][k], want_m[k], rtol=2e-4,
                                   atol=2e-4, err_msg=k)
    np.testing.assert_allclose(_param_sum(case, got["model"]), want_sum,
                               rtol=2e-5)


@pytest.mark.parametrize("case", ALL_IDS)
def test_two_rank_step_matches_one_process(steps, case):
    ranks, one, _ = steps
    got, want = ranks[0][case], one[case]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(_param_sum(case, got["model"]),
                               _param_sum(case, want["model"]), rtol=2e-5)
    if "critic" in want:
        for k, v in want["critic"].items():
            torch.testing.assert_close(got["critic"][k], v, rtol=1e-4,
                                       atol=1e-6)


def test_ranks_end_each_step_in_the_same_state(steps):
    r0, r1 = steps[0]
    assert set(r0) == set(ALL_IDS)
    for case in ALL_IDS:
        assert r0[case]["metrics"] == r1[case]["metrics"], case
        for part in ("model", "critic"):
            for k, v in r0[case].get(part, {}).items():
                assert torch.equal(v, r1[case][part][k]), (case, k)
