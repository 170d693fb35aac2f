"""The port's `param_shardings` (parallel/tensor.py) against the JAX
package's (`vln_imagine_tpu/parallel/mesh.py:param_shardings`), leaf for
leaf through the bridge's key map, and the slices `shard_module` cuts:

- at the tiny configs (f32, `min_size` 2^10 as the JAX package's mesh
  test): HAMT, DUET and the critic, model axes 2 and 4, from each
  package's init;
- at the released full-width configs, shapes only (`jax.eval_shape` on the
  JAX side, the meta device on the port's): HAMT, DUET and the critic,
  model axes 2, 3 and 4 at the default `min_size`.  At 3 the [768, 512]
  kernels (the critic's, the alignment head's first) are split on their
  input axis (512 % 3 != 0) and the [512, 512] one stays whole; every
  other split is on the output axis.  The census's counts and per-rank f32
  bytes are fixed below (at 2: HAMT 343.5 MB of 685.8, DUET 363.6 of
  726.2);
- every rank's slices, joined as `Split` lays them out (the packed
  `in_proj_weight` as three blocks), give the whole parameter back.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from vln_imagine_tpu.config import duet_r2r_config as j_duet_r2r_config
from vln_imagine_tpu.config import hamt_r2r_config as j_hamt_r2r_config
from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu.models.bert import Critic as JCritic
from vln_imagine_tpu.models.duet import DuetModel as JDuetModel
from vln_imagine_tpu.models.hamt import HamtModel as JHamtModel
from vln_imagine_tpu.parallel.mesh import make_mesh as j_make_mesh
from vln_imagine_tpu.parallel.mesh import param_shardings as j_param_shardings
from vln_imagine_tpu.train.trainer import _init_params
from vln_imagine_tpu.train.trainer_duet import _init_duet_params
from vln_imagine_tpu_torch.ckpt.convert import (
    critic_torch_to_flax_path,
    duet_torch_to_flax_path,
    hamt_torch_to_flax_path,
)
from vln_imagine_tpu_torch.config import (
    duet_r2r_config,
    hamt_r2r_config,
    tiny_test_config,
)
from vln_imagine_tpu_torch.models.bert import Critic
from vln_imagine_tpu_torch.models.duet import DuetModel
from vln_imagine_tpu_torch.models.hamt import HamtModel
from vln_imagine_tpu_torch.parallel.tensor import (
    MIN_SIZE,
    ModelShard,
    param_shardings,
    shard_module,
    split_of,
)

torch.set_num_threads(2)

TINY_MIN_SIZE = 2 ** 10
PORT = {"hamt": (HamtModel, hamt_torch_to_flax_path),
        "duet": (DuetModel, duet_torch_to_flax_path),
        "critic": (Critic, critic_torch_to_flax_path)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def _world_ep(cfg, num_nodes):
    world, _ = synthetic_world(
        num_scans=1, num_nodes=num_nodes, max_candidates=cfg.env.max_candidates,
        views=cfg.env.views, feat_dim=cfg.model.image_feat_size, seed=11)
    ep = synthetic_episodes(
        world, batch=1, max_gt_path_len=cfg.env.max_gt_path_len,
        max_instr_len=cfg.env.max_instr_len,
        max_imaginations=cfg.model.max_imagination_len,
        vocab_size=cfg.model.vocab_size, feat_dim=cfg.model.hidden_size,
        seed=12)
    return jax.tree.map(jnp.asarray, world), jax.tree.map(jnp.asarray, ep)


def _jax_params(agent: str, jcfg, abstract: bool):
    """The JAX package's params of `agent` (initialized, or with `abstract`
    their shapes only)."""
    if agent == "critic":
        fn = lambda r: JCritic(jcfg.model).init(  # noqa: E731
            r, jnp.zeros((1, jcfg.model.hidden_size)))
    else:
        world, ep = _world_ep(jcfg, 4 if abstract else 14)
        if agent == "hamt":
            model = JHamtModel(jcfg.model, feat_dropout=jcfg.train.feat_dropout)
            fn = lambda r: _init_params(model, jcfg, world, ep, r)  # noqa: E731
        else:
            model = JDuetModel(jcfg.model, feat_dropout=jcfg.train.feat_dropout)
            fn = lambda r: _init_duet_params(  # noqa: E731
                model, jcfg, world, ep, r)
    key = jax.random.PRNGKey(0)
    return (jax.eval_shape(fn, key) if abstract else fn(key))["params"]


def _jax_axes(params, m: int, min_size: int) -> dict:
    """{flax leaf path: the axis the JAX rule puts on 'model', or None}."""
    mesh = j_make_mesh(data=1, model=m, devices=jax.devices()[:m])
    specs = j_param_shardings(params, mesh, min_size=min_size)
    axes = {P(None, "model"): 1, P("model", None): 0, P(): None}
    return {path: axes[s.spec] for path, s in _leaves(specs)}


def _port_axes(agent: str, model, m: int, min_size: int) -> dict:
    """The port's `param_shardings` as {flax leaf path: flax axis or None}
    through the bridge: a Dense kernel is the transposed weight, an
    embedding the table itself, and the packed in_proj three kernels."""
    to_flax = PORT[agent][1]
    out = {}
    for name, dim in param_shardings(model, m, min_size=min_size).items():
        path = to_flax(name)
        leaf = path.rpartition("/")[2]
        if leaf.startswith("__self_attn.in_proj_"):
            base = path.rpartition("/")[0] + "/self_attn"
            kernel = leaf.endswith("weight")
            for part in ("query", "key", "value"):
                out[f"{base}/{part}/{'kernel' if kernel else 'bias'}"] = (
                    None if dim is None else 1 - dim)
            continue
        if leaf == "embedding":
            out[path] = dim
        elif leaf == "weight" and model.get_parameter(name).dim() == 2:
            out[path.rpartition("/")[0] + "/kernel"] = (None if dim is None
                                                       else 1 - dim)
        else:
            assert dim is None, name
            out[path] = None
    return out


def _same_layout(port: dict, jax_axes: dict) -> None:
    """The two layouts over the same leaves: the JAX leaf names (`scale`,
    `kernel`, a LayerNorm's `ln/scale`) matched to the port's paths."""
    def norm(path):
        head, _, leaf = path.rpartition("/")
        return f"{head}/{'weight' if leaf in ('scale', 'weight') else leaf}"
    got = {norm(p): a for p, a in port.items()}
    want = {norm(p): a for p, a in jax_axes.items()}
    assert got.keys() == want.keys()
    diff = {p: (got[p], want[p]) for p in want if got[p] != want[p]}
    assert not diff, diff


@pytest.fixture(scope="module")
def tiny_params():
    out = {}
    for agent in ("hamt", "duet", "critic"):
        jcfg = j_tiny_test_config("duet" if agent == "duet" else "hamt")
        out[agent] = _jax_params(agent, jcfg, abstract=False)
    return out


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("agent", ["hamt", "duet", "critic"])
def test_tiny_layout_equals_jax_param_shardings(tiny_params, agent, m):
    cfg = tiny_test_config("duet" if agent == "duet" else "hamt")
    model = PORT[agent][0](cfg.model)
    port = _port_axes(agent, model, m, TINY_MIN_SIZE)
    _same_layout(port, _jax_axes(tiny_params[agent], m, TINY_MIN_SIZE))
    assert any(a is not None for a in port.values())


@pytest.fixture(scope="module")
def released_shapes():
    return {agent: _jax_params(
        agent, j_duet_r2r_config() if agent == "duet" else j_hamt_r2r_config(),
        abstract=True) for agent in ("hamt", "duet", "critic")}


def _meta_model(agent):
    cfg = duet_r2r_config() if agent == "duet" else hamt_r2r_config()
    with torch.device("meta"):
        return PORT[agent][0](cfg.model)


# agent, m -> (split tensors, split on the input axis, f32 bytes a rank)
CENSUS = {
    ("hamt", 2): (139, 0, 343_451_652), ("hamt", 3): (138, 1, 230_044_676),
    ("hamt", 4): (139, 0, 172_292_612),
    ("duet", 2): (152, 0, 363_628_564), ("duet", 3): (151, 1, 243_485_716),
    ("duet", 4): (152, 0, 182_365_716),
    ("critic", 2): (1, 0, 790_532), ("critic", 3): (1, 1, 528_388),
    ("critic", 4): (1, 0, 397_316),
}


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("agent", ["hamt", "duet", "critic"])
def test_released_layout_equals_jax_param_shardings(released_shapes, agent,
                                                    m):
    model = _meta_model(agent)
    port = _port_axes(agent, model, m, MIN_SIZE)
    _same_layout(port, _jax_axes(released_shapes[agent], m, MIN_SIZE))
    specs = param_shardings(model, m)
    n_split = sum(d is not None for d in specs.values())
    n_input = sum(a == 0 for a in port.values())
    held = sum(p.numel() * 4 // (1 if specs[n] is None else m)
               for n, p in model.named_parameters())
    assert (n_split, n_input, held) == CENSUS[agent, m]


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("agent", ["hamt", "duet", "critic"])
def test_every_ranks_slices_join_to_the_whole(agent, m):
    cfg = tiny_test_config("duet" if agent == "duet" else "hamt")
    g = torch.Generator().manual_seed(m)
    whole = PORT[agent][0](cfg.model)
    with torch.no_grad():
        for p in whole.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    specs = param_shardings(whole, m, min_size=TINY_MIN_SIZE)
    ranks = []
    for r in range(m):
        model = PORT[agent][0](cfg.model)
        model.load_state_dict(whole.state_dict())
        ranks.append(dict(shard_module(model, ModelShard(None, r, m),
                                       specs).named_parameters()))
    for name, p in whole.named_parameters():
        parts = [rk[name] for rk in ranks]
        split = split_of(parts[0])
        if specs[name] is None:
            assert split is None and all(torch.equal(x, p) for x in parts)
            continue
        assert (split.dim, split.blocks) == (
            specs[name], 3 if name.endswith("in_proj_weight") else 1)
        assert [split_of(x).shard.rank for x in parts] == list(range(m))
        d = split.dim
        joined = torch.stack([x.unflatten(d, (split.blocks, -1))
                              for x in parts], d + 1).flatten(d, d + 2)
        assert torch.equal(joined, p), name
