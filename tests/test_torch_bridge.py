"""The weight bridge between the JAX package's flax params and the port's
state_dict: complete coverage both ways at the tiny and the released
config, and an exact flax -> port -> flax round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vln_imagine_tpu.config import hamt_r2r_config as j_hamt_r2r_config
from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu.models.hamt import HamtModel as JHamtModel
from vln_imagine_tpu.train.trainer import _init_params
from vln_imagine_tpu_torch.ckpt.convert import (
    flax_from_state_dict,
    flax_to_hamt_torch_key,
    state_dict_from_flax,
    strip_reference_prefixes,
)
from vln_imagine_tpu_torch.config import hamt_r2r_config, tiny_test_config
from vln_imagine_tpu_torch.models.hamt import HamtModel

torch.set_num_threads(2)


def _world_ep(cfg, num_nodes, batch):
    world, _ = synthetic_world(
        num_scans=1, num_nodes=num_nodes, max_candidates=cfg.env.max_candidates,
        views=cfg.env.views, feat_dim=cfg.model.image_feat_size, seed=11)
    ep = synthetic_episodes(
        world, batch=batch, max_gt_path_len=cfg.env.max_gt_path_len,
        max_instr_len=cfg.env.max_instr_len,
        max_imaginations=cfg.model.max_imagination_len,
        vocab_size=cfg.model.vocab_size, feat_dim=cfg.model.hidden_size,
        seed=12)
    return jax.tree.map(jnp.asarray, world), jax.tree.map(jnp.asarray, ep)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def test_tiny_jax_init_loads_strict_and_round_trips():
    cfg = j_tiny_test_config("hamt")
    world, ep = _world_ep(cfg, num_nodes=14, batch=1)
    model = JHamtModel(cfg.model, feat_dropout=cfg.train.feat_dropout)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda r: _init_params(model, cfg, world, ep, r))(jax.random.PRNGKey(42)))

    port = HamtModel(tiny_test_config("hamt").model)
    sd = state_dict_from_flax(params)
    result = port.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert len(sd) == len(list(_leaves(params["params"])))

    back = flax_from_state_dict(port.state_dict())
    got, want = dict(_leaves(back["params"])), dict(_leaves(params["params"]))
    assert set(got) == set(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def test_released_config_coverage_both_ways():
    cfg = j_hamt_r2r_config()
    world, ep = _world_ep(cfg, num_nodes=4, batch=1)
    model = JHamtModel(cfg.model, feat_dropout=cfg.train.feat_dropout)
    shapes = jax.eval_shape(
        lambda r: _init_params(model, cfg, world, ep, r), jax.random.PRNGKey(0))
    leaves = dict(_leaves(shapes["params"]))
    assert len(leaves) == 391
    assert abs(sum(int(np.prod(s.shape)) for s in leaves.values())
               - 171.4e6) < 0.05e6

    with torch.device("meta"):
        port = HamtModel(hamt_r2r_config().model)
    port_shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    mapped = {}
    for path, s in leaves.items():
        key = flax_to_hamt_torch_key(path)
        shape = tuple(s.shape)[::-1] if path.endswith("/kernel") else tuple(s.shape)
        mapped[key] = shape
    assert mapped == port_shapes


def test_reference_prefixes_strip_to_port_keys():
    sd = {"module.vln_bert.embeddings.word_embeddings.weight": 1,
          "bert.encoder.layer.0.output.dense.bias": 2,
          "next_action.net.4.weight": 3}
    assert strip_reference_prefixes(sd) == {
        "embeddings.word_embeddings.weight": 1,
        "encoder.layer.0.output.dense.bias": 2,
        "next_action.net.4.weight": 3}
