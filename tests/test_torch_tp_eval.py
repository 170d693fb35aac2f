"""Greedy eval of the port on a model axis, on the CPU: gloo processes on
meshes of 1 x 2 and 2 x 2 (data x model), the parameters of at least 2^10
elements split as the JAX package's `param_shardings` splits them (its
mesh test's `min_size`), at the tiny configs (4 heads: 2 a rank, each
rank's attention on its own heads), f32, a batch of 8:

- HAMT from the JAX init and DUET from the seeded init: paths and lengths
  identical to the port's one-process eval, the first step's logits within
  1e-4 of it;
- HAMT: paths and lengths identical to the JAX package's eval with its
  params placed by its `param_shardings` on the same mesh shape (the
  oracle of `tests/test_mesh.py:test_tp_param_shardings_split_large_kernels`);
- the ranks of a model axis agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dp import (
    EVAL_BATCH,
    TP_MIN_SIZE,
    finish,
    start,
    tp_eval_cases,
    world_and_episodes,
)
from vln_imagine_tpu import config as JC
from vln_imagine_tpu.envx import synthetic_episodes as j_episodes
from vln_imagine_tpu.envx import synthetic_world as j_world
from vln_imagine_tpu.parallel.mesh import make_mesh as j_make_mesh
from vln_imagine_tpu.parallel.mesh import param_shardings as j_param_shardings
from vln_imagine_tpu.parallel.mesh import shard_batch as j_shard_batch
from vln_imagine_tpu.train.trainer import HamtTrainer as JHamtTrainer
from vln_imagine_tpu_torch.ckpt.convert import state_dict_from_flax

torch.set_num_threads(2)

MESHES = {"1x2": (1, 2), "2x2": (2, 2)}


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    """(rank results by mesh, the port's one process, the JAX placed
    evals by mesh)."""
    out = tmp_path_factory.mktemp("tp_eval")
    cfg = JC.tiny_test_config("hamt")
    world, _, ep = world_and_episodes(cfg, EVAL_BATCH, world_seed=0, ep_seed=1,
                                      world_fn=j_world, episodes_fn=j_episodes)
    world, ep = (jax.tree.map(jnp.asarray, x) for x in (world, ep))
    jtr = JHamtTrainer(cfg, world, rng=jax.random.PRNGKey(3))
    state = jtr.init_state(ep)
    dirs = {}
    for name in MESHES:
        dirs[name] = out / name
        dirs[name].mkdir()
        torch.save(state_dict_from_flax(jax.tree.map(np.asarray,
                                                     state.params)),
                   dirs[name] / "hamt_eval_init.pt")
    procs = {name: start("tp_eval", dirs[name], world=d * m, model=m)
             for name, (d, m) in MESHES.items()}
    try:
        jax_paths = {}
        ev = jtr.make_eval_step()
        for name, (d, m) in MESHES.items():
            mesh = j_make_mesh(data=d, model=m, devices=jax.devices()[:d * m])
            placed = jax.tree.map(jax.device_put, state.params,
                                  j_param_shardings(state.params, mesh,
                                                    min_size=TP_MIN_SIZE))
            paths, lens = ev(placed, j_shard_batch(ep, mesh),
                             jax.random.PRNGKey(5))
            jax_paths[name] = (np.asarray(paths), np.asarray(lens))
        one = tp_eval_cases(None, dirs["1x2"])
    except BaseException:
        for ps in procs.values():
            for p in ps:
                p.kill()
                p.wait()
        raise
    ranks = {name: finish(procs[name], "tp_eval", dirs[name], timeout=300)
             for name in MESHES}
    return ranks, one, jax_paths


def _joined(ranks, agent, key, data):
    """The data ranks' rows, joined (model rank 0 of each data rank)."""
    m = len(ranks) // data
    return np.concatenate([ranks[d * m][agent][key] for d in range(data)])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("agent", ["hamt", "duet"])
def test_tp_eval_paths_equal_one_process(evals, agent, mesh):
    ranks, one, _ = evals
    data = MESHES[mesh][0]
    for key in ("paths", "lens"):
        np.testing.assert_array_equal(_joined(ranks[mesh], agent, key, data),
                                      one[agent][key])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("agent", ["hamt", "duet"])
def test_tp_first_step_logits_within_1e4_of_one_process(evals, agent, mesh):
    ranks, one, _ = evals
    got = _joined(ranks[mesh], agent, "logits", MESHES[mesh][0])
    want = one[agent]["logits"]
    assert got.shape == want.shape
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=1e-4)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_hamt_eval_equals_the_jax_placed_eval(evals, mesh):
    ranks, _, jax_paths = evals
    data = MESHES[mesh][0]
    paths, lens = jax_paths[mesh]
    np.testing.assert_array_equal(_joined(ranks[mesh], "hamt", "lens", data),
                                  lens)
    np.testing.assert_array_equal(_joined(ranks[mesh], "hamt", "paths", data),
                                  paths)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_the_ranks_of_a_model_axis_agree(evals, mesh):
    ranks = evals[0][mesh]
    m = MESHES[mesh][1]
    for r, res in enumerate(ranks):
        head = ranks[r // m * m]
        for agent in ("hamt", "duet"):
            for key in ("paths", "lens", "logits"):
                np.testing.assert_array_equal(res[agent][key],
                                              head[agent][key])
