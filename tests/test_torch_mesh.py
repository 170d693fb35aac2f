"""The port's `parallel/mesh.py` and the leftovers of the slice, on the CPU:

- two gloo processes: the mesh's dims, each rank's block of rows from
  `shard_batch`, a model axis over both processes (`data` 1 or -1), the
  refusal of a mesh that does not cover the processes; greedy eval with
  each rank on its rows of a batch of 8: HAMT (from the JAX init) bitwise
  equal to the JAX package's eval on `make_mesh(data=2)` and to the
  port's one process, DUET (whose map takes rank 0's first next-hop
  tables) bitwise equal to the port's one process;
- `config_to_json` / `config_from_json`: a round trip of every preset, and
  the JSON of the JAX package's preset;
- `length_to_mask` and `masked_softmax` against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dp import EVAL_BATCH, eval_cases, spawn, world_and_episodes
from vln_imagine_tpu import config as JC
from vln_imagine_tpu.envx import synthetic_episodes as j_episodes
from vln_imagine_tpu.envx import synthetic_world as j_world
from vln_imagine_tpu.ops import masks as JM
from vln_imagine_tpu.parallel.mesh import make_mesh as j_make_mesh
from vln_imagine_tpu.parallel.mesh import shard_batch as j_shard_batch
from vln_imagine_tpu.train.trainer import HamtTrainer as JHamtTrainer
from vln_imagine_tpu_torch import config as PC
from vln_imagine_tpu_torch.ckpt.convert import state_dict_from_flax
from vln_imagine_tpu_torch.ops import NEG_INF_MASK, length_to_mask, masked_softmax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    """(rank results, the port's one-process paths, the JAX mesh paths)."""
    out = tmp_path_factory.mktemp("mesh_eval")
    cfg = JC.tiny_test_config("hamt")
    world, _, ep = world_and_episodes(cfg, EVAL_BATCH, world_seed=0, ep_seed=1,
                                      world_fn=j_world, episodes_fn=j_episodes)
    world, ep = (jax.tree.map(jnp.asarray, x) for x in (world, ep))
    jtr = JHamtTrainer(cfg, world, rng=jax.random.PRNGKey(3))
    state = jtr.init_state(ep)
    torch.save(state_dict_from_flax(jax.tree.map(np.asarray, state.params)),
               out / "hamt_eval_init.pt")
    ranks = spawn("mesh_eval", out, timeout=240)
    mesh = j_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    paths, lens = jtr.make_eval_step()(state.params, j_shard_batch(ep, mesh),
                                       jax.random.PRNGKey(5))
    return ranks, eval_cases(None, out), (np.asarray(paths), np.asarray(lens))


def _joined(ranks, agent):
    return tuple(np.concatenate([r[agent][i] for r in ranks]) for i in (0, 1))


def _assert_same_paths(got, want):
    (gp, gl), (wp, wl) = got, want
    np.testing.assert_array_equal(gl, wl)
    for b in range(len(wl)):
        np.testing.assert_array_equal(gp[b, :wl[b]], wp[b, :wl[b]])
    np.testing.assert_array_equal(gp, wp)


def test_mesh_dims_and_rows_per_rank(evals):
    ranks = evals[0]
    for rank, r in enumerate(ranks):
        assert r["mesh"] == (("data", "model"), (2, 1))
        np.testing.assert_array_equal(r["rows"]["a"],
                                      np.arange(8)[rank * 4:(rank + 1) * 4])
        assert torch.equal(r["rows"]["b"], torch.arange(6)[rank * 3:rank * 3 + 3])
        assert r["rows"]["s"] == 3


def test_make_mesh_refuses_a_model_axis_and_a_bad_shape(evals):
    """The model axis is ported (item 7c): `make_mesh(data=1, model=2)`
    and `make_mesh(data=-1, model=2)` put both processes on one data rank
    and a model axis of 2, rank r at model rank r; a mesh that does not
    cover the processes is still refused."""
    for rank, r in enumerate(evals[0]):
        for data in (1, -1):
            assert r["model_meshes"][data] == (("data", "model"), (1, 2),
                                               (rank, 2), (0, 1))
        assert r["errors"] == {"shape": "ValueError: mesh 3x1 != 2 processes"}


def test_two_rank_hamt_eval_matches_the_jax_mesh_eval(evals):
    ranks, _, jax_paths = evals
    _assert_same_paths(_joined(ranks, "hamt"), jax_paths)


@pytest.mark.parametrize("agent", ["hamt", "duet"])
def test_two_rank_eval_matches_one_process(evals, agent):
    ranks, one, _ = evals
    _assert_same_paths(_joined(ranks, agent), one[agent])


PRESETS = [("hamt_r2r_config", ()), ("duet_r2r_config", ()), ("rxr_config", ()),
           ("r4r_config", ()), ("cvdn_config", ()), ("soon_config", ()),
           ("reverie_config", ("hamt",)), ("reverie_config", ("duet",)),
           ("tiny_test_config", ("hamt",)), ("tiny_test_config", ("duet",))]


@pytest.mark.parametrize("name, args", PRESETS,
                         ids=[f"{n}{''.join('-' + a for a in args)}"
                              for n, args in PRESETS])
def test_config_json_round_trip_equals_the_jax_json(name, args):
    cfg = getattr(PC, name)(*args)
    text = PC.config_to_json(cfg)
    assert text == JC.config_to_json(getattr(JC, name)(*args))
    assert PC.config_from_json(text) == cfg
    cfg2 = PC._replace(cfg, "mesh", data_parallelism=-1)
    assert PC.config_from_json(PC.config_to_json(cfg2)) == cfg2


def test_masks_match_jax():
    rng = np.random.default_rng(0)
    lengths = np.array([0, 3, 7, 5], np.int32)
    np.testing.assert_array_equal(
        length_to_mask(torch.from_numpy(lengths), 7).numpy(),
        np.asarray(JM.length_to_mask(jnp.asarray(lengths), 7)))
    logits = rng.standard_normal((4, 7)).astype(np.float32)
    mask = np.array(JM.length_to_mask(jnp.asarray(lengths), 7))
    got = masked_softmax(torch.from_numpy(logits), torch.from_numpy(mask))
    want = np.asarray(JM.masked_softmax(jnp.asarray(logits), jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert got[0].sum() == 0  # a row without valid entries
    assert NEG_INF_MASK == JM.NEG_INF_MASK
