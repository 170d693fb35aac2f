"""The port's DuetModel and its weight bridge against the JAX package's, on
the CPU in float32:

- every DuetModel mode against `DuetModel.apply` with the same weights (the
  port's seeded init carried across by the bridge) and the same numpy
  inputs, navigation under every `fusion` value; one navigation step at
  the released width, batch 1;
- the bridge: the JAX init loads strict into the port and round-trips
  exactly (the pano encoder's packed in_proj included), and every flax leaf
  of the tiny and the released config maps to a port key of the right
  shape, both ways.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_imagine_tpu.config import duet_r2r_config as j_duet_r2r_config
from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu.models.duet import DuetModel as JDuetModel
from vln_imagine_tpu.train.trainer_duet import _init_duet_params
from vln_imagine_tpu.ckpt.convert import (
    bert_remap_for_duet as j_bert_remap_for_duet,
)
from vln_imagine_tpu.ckpt.convert import (
    duet_torch_to_flax_path as j_duet_torch_to_flax_path,
)
from vln_imagine_tpu_torch.ckpt.convert import (
    bert_remap_for_duet,
    duet_torch_to_flax_path,
    flax_from_state_dict,
    flax_to_torch_key,
    state_dict_from_flax,
)
from vln_imagine_tpu_torch.config import duet_r2r_config, tiny_test_config
from vln_imagine_tpu_torch.models.duet import DuetModel
from vln_imagine_tpu_torch.train.trainer import init_params

torch.set_num_threads(2)

TOL = 1e-4  # tests/test_reference_parity_duet.py
B, L, I = 3, 16, 4


def _with(cfg, part, **kw):
    return dataclasses.replace(
        cfg, **{part: dataclasses.replace(getattr(cfg, part), **kw)})


def _models(pcfg, jcfg, seed=5):
    port = DuetModel(pcfg.model).eval()
    init_params(port, torch.Generator().manual_seed(seed))
    params = flax_from_state_dict(port.state_dict(), "duet")
    jmodel = JDuetModel(jcfg.model, feat_dropout=jcfg.train.feat_dropout)
    return port, jmodel, params


@pytest.fixture(scope="module")
def tiny():
    return _models(tiny_test_config("duet"), j_tiny_test_config("duet"))


def _inputs(mcfg, ecfg, batch=B, seed=0):
    rng = np.random.default_rng(seed)
    H, Df, A = mcfg.hidden_size, mcfg.image_feat_size, mcfg.angle_feat_size
    Lt = ecfg.max_instr_len
    G1 = ecfg.max_gmap_nodes + 1
    T1 = ecfg.max_candidates + ecfg.views + 1
    txt_len = rng.integers(Lt // 2, Lt + 1, batch)
    txt_mask = np.arange(Lt)[None] < txt_len[:, None]
    n_nodes = rng.integers(3, G1, batch)
    gmap_valid = np.arange(G1)[None] < n_nodes[:, None]
    gmap_visited = (rng.random((batch, G1)) < 0.3) & gmap_valid
    gmap_visited[:, 0] = False
    vp_valid = rng.random((batch, T1)) < 0.8
    vp_valid[:, 0] = True
    vp_nav = vp_valid & (np.arange(T1)[None] <= ecfg.max_candidates)
    c2g = np.zeros((batch, G1, T1), bool)
    for b in range(batch):
        for j in range(1, ecfg.max_candidates + 1):
            g = rng.integers(1, n_nodes[b])
            c2g[b, g, j] = vp_nav[b, j] and rng.random() < 0.7
    pair = rng.uniform(0, 12, (batch, G1, G1)).astype(np.float32)
    np_w = np.zeros((batch, mcfg.max_imagination_len, Lt), np.float32)
    np_w[0, 0, 2:4] = 0.5
    np_w[-1, 1, 5] = 1.0
    return dict(
        txt_ids=np.where(txt_mask, rng.integers(4, mcfg.vocab_size,
                                                (batch, Lt)), 0).astype(np.int32),
        txt_mask=txt_mask,
        txt_embeds=rng.standard_normal((batch, Lt, H)).astype(np.float32),
        imagine_feats=rng.standard_normal(
            (batch, mcfg.max_imagination_len, H)).astype(np.float32),
        imagine_mask=rng.random((batch, mcfg.max_imagination_len)) < 0.7,
        np_weights=np_w,
        view_img=rng.standard_normal((batch, T1 - 1, Df)).astype(np.float32),
        loc=rng.standard_normal((batch, T1 - 1, A + 3)).astype(np.float32),
        nav_types=(np.arange(T1 - 1)[None] < ecfg.max_candidates
                   ).astype(np.int32).repeat(batch, 0),
        pano_valid=vp_valid[:, 1:],
        gmap_img=rng.standard_normal((batch, G1, H)).astype(np.float32),
        gmap_step_ids=rng.integers(0, 6, (batch, G1)).astype(np.int32),
        gmap_pos=rng.standard_normal((batch, G1, A + 3)).astype(np.float32),
        gmap_valid=gmap_valid, gmap_pair=pair * gmap_valid[:, :, None]
        * gmap_valid[:, None, :],
        gmap_visited=gmap_visited,
        vp_img=rng.standard_normal((batch, T1, H)).astype(np.float32),
        vp_pos=rng.standard_normal((batch, T1, 2 * (A + 3))).astype(np.float32),
        vp_valid=vp_valid, vp_nav_valid=vp_nav, cand_to_gmap=c2g,
    )


def _run(mode, model, x, jax_side, params=None):
    """One mode on either side with the same numpy inputs."""
    if jax_side:
        c = jnp.asarray

        def call(method, *args, **kw):
            return model.apply(params, *args, method=method,
                               deterministic=True, **kw)
        M = JDuetModel
    else:
        def c(a):
            return torch.from_numpy(np.asarray(a))

        def call(method, *args, **kw):
            with torch.no_grad():
                return method(model, *args, **kw)
        M = DuetModel
    if mode == "text":
        return [call(M.text, c(x["txt_ids"]), c(x["txt_mask"]))]
    if mode == "imagine":
        return [call(M.imagine, c(x["imagine_feats"]))]
    if mode == "align_with_contrastive_loss":
        return list(call(M.align_with_contrastive_loss, c(x["txt_embeds"]),
                         c(x["txt_mask"]), c(x["imagine_feats"]),
                         c(x["imagine_mask"]), c(x["np_weights"])))
    if mode == "panorama_per_step":
        return [call(M.panorama_per_step, c(x["view_img"]), c(x["loc"]),
                     c(x["nav_types"]), c(x["pano_valid"]))]
    if mode == "navigation_per_step":
        out = call(M.navigation_per_step, c(x["txt_embeds"]), c(x["txt_mask"]),
                   c(x["gmap_img"]), c(x["gmap_step_ids"]), c(x["gmap_pos"]),
                   c(x["gmap_valid"]), c(x["gmap_pair"]), c(x["gmap_visited"]),
                   c(x["vp_img"]), c(x["vp_pos"]), c(x["vp_valid"]),
                   c(x["vp_nav_valid"]), c(x["cand_to_gmap"]),
                   imagine_embeds=c(x["imagine_feats"]),
                   imagine_mask=c(x["imagine_mask"]))
        return [out.global_logits, out.local_logits, out.fused_logits,
                out.gmap_embeds, out.vp_embeds]
    raise ValueError(mode)


def _assert_modes_match(port, jmodel, params, mode, x):
    got = _run(mode, port, x, jax_side=False)
    want = _run(mode, jmodel, x, jax_side=True, params=params)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, (mode, i)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg=f"{mode} output {i}")
    return got


MODES = ["text", "imagine", "align_with_contrastive_loss", "panorama_per_step"]


@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_jax(tiny, mode):
    port, jmodel, params = tiny
    cfg = tiny_test_config("duet")
    got = _assert_modes_match(port, jmodel, params, mode,
                              _inputs(cfg.model, cfg.env))
    if mode == "align_with_contrastive_loss":
        assert float(got[0]) > 0.0


@pytest.mark.parametrize("fusion", ["dynamic", "avg", "global", "local"])
def test_navigation_matches_jax_for_every_fusion(fusion):
    pcfg = _with(tiny_test_config("duet"), "model", fusion=fusion)
    jcfg = _with(j_tiny_test_config("duet"), "model", fusion=fusion)
    port, jmodel, params = _models(pcfg, jcfg)
    x = _inputs(pcfg.model, pcfg.env, seed=1)
    got = _assert_modes_match(port, jmodel, params, "navigation_per_step", x)
    # the graph bias reaches the global branch: other distances, other output
    x2 = dict(x, gmap_pair=x["gmap_pair"] * 2.0)
    moved = _run("navigation_per_step", port, x2, jax_side=False)
    assert not np.allclose(moved[3].numpy(), got[3].numpy())


def test_navigation_at_released_width():
    """One navigation step at the released width (hidden 768, 12 heads,
    4 cross-modal layers per branch, 200 text tokens), batch 1."""
    pcfg = _with(duet_r2r_config(), "model", compute_dtype="float32")
    jcfg = _with(j_duet_r2r_config(), "model", compute_dtype="float32",
                 use_pallas_attention=False)
    port, jmodel, params = _models(pcfg, jcfg)
    x = _inputs(pcfg.model, pcfg.env, batch=1, seed=2)
    _assert_modes_match(port, jmodel, params, "navigation_per_step", x)


# ------------------------------------------------------------------ bridge
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


def test_tiny_jax_init_loads_strict_and_round_trips():
    cfg = j_tiny_test_config("duet")
    world, ep = _world_ep(cfg, num_nodes=14)
    model = JDuetModel(cfg.model, feat_dropout=cfg.train.feat_dropout)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda r: _init_duet_params(model, cfg, world, ep, r))(
            jax.random.PRNGKey(42)))
    port = DuetModel(tiny_test_config("duet").model)
    sd = state_dict_from_flax(params, "duet")
    result = port.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    n_layers = cfg.model.num_pano_layers
    # q/k/v kernels and biases of each pano layer stack into two tensors
    assert len(sd) == len(list(_leaves(params["params"]))) - 4 * n_layers
    w = sd["img_embeddings.pano_encoder.layers.0.self_attn.in_proj_weight"]
    H = cfg.model.hidden_size
    np.testing.assert_array_equal(
        w[H:2 * H].numpy(),
        params["params"]["pano_encoder"]["layer_0"]["self_attn"]["key"]
        ["kernel"].T)

    back = flax_from_state_dict(port.state_dict(), "duet")
    got, want = dict(_leaves(back["params"])), dict(_leaves(params["params"]))
    assert set(got) == set(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


@pytest.mark.parametrize("which", ["tiny", "released"])
def test_coverage_both_ways(which):
    """Every flax leaf maps to a port key of its shape (the pano q/k/v
    kernels and biases to the packed in_proj rows), and every port key maps
    back to flax leaves."""
    jcfg = j_tiny_test_config("duet") if which == "tiny" else j_duet_r2r_config()
    pcfg = tiny_test_config("duet") if which == "tiny" else duet_r2r_config()
    world, ep = _world_ep(jcfg, num_nodes=4 if which == "released" else 14)
    model = JDuetModel(jcfg.model, feat_dropout=jcfg.train.feat_dropout)
    shapes = jax.eval_shape(
        lambda r: _init_duet_params(model, jcfg, world, ep, r),
        jax.random.PRNGKey(0))
    leaves = {p: tuple(s.shape) for p, s in _leaves(shapes["params"])}
    with torch.device("meta"):
        port = DuetModel(pcfg.model)
    port_shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}

    mapped = {}
    for path, s in leaves.items():
        if "/self_attn/" in path and path.startswith("pano_encoder/"):
            layer = path.split("/")[1].split("_")[1]
            key = f"img_embeddings.pano_encoder.layers.{layer}.self_attn.in_proj_"
            if path.endswith("/kernel"):  # [in, out] -> rows of [3H, H]
                rows, _ = mapped.get(key + "weight", (0, s[0]))
                mapped[key + "weight"] = (rows + s[1], s[0])
            else:
                mapped[key + "bias"] = (mapped.get(key + "bias", (0,))[0]
                                        + s[0],)
            continue
        key = flax_to_torch_key(path, "duet")
        mapped[key] = s[::-1] if path.endswith("/kernel") else s
    assert mapped == port_shapes
    for key in port_shapes:
        assert duet_torch_to_flax_path(key) is not None, key
    if which == "released":
        assert len(port_shapes) == len(leaves) - 4 * jcfg.model.num_pano_layers
        n = sum(int(np.prod(s)) for s in port_shapes.values())
        assert n == sum(int(np.prod(s)) for s in leaves.values())


def test_key_map_and_bert_remap_match_jax():
    """The port's copy of the DUET key map and of the HF BERT remap give
    the JAX package's answer for every port key, reference-prefixed keys and
    the keys the map drops."""
    with torch.device("meta"):
        port = DuetModel(duet_r2r_config().model)
    keys = list(port.state_dict())
    keys += [f"module.vln_bert.{k}" for k in keys[:20]]
    keys += ["bert.pooler.dense.weight", "lang2visn.x", "mlm_head.predictions.bias",
             "global_encoder.encoder.x_layers.0.lang_self_att.self.query.bias"]
    for key in keys:
        assert duet_torch_to_flax_path(key) == j_duet_torch_to_flax_path(key), key
    hf = {"module.encoder.layer.3.output.dense.weight": 1,
          "embeddings.word_embeddings.weight": 2, "pooler.dense.bias": 3}
    assert bert_remap_for_duet(hf) == j_bert_remap_for_duet(hf) == {
        "lang_encoder.layer.3.output.dense.weight": 1,
        "embeddings.word_embeddings.weight": 2, "pooler.dense.bias": 3}


def test_full_imagination_encoder_refused_as_in_jax():
    """DUET has only the bypass imagination embeddings, in the reference and
    in the JAX package: both packages refuse `bypass_imag_encoder=False`
    with a ValueError (HAMT has the full encoder)."""
    jcfg = dataclasses.replace(j_tiny_test_config("duet").model,
                               bypass_imag_encoder=False)
    with pytest.raises(ValueError, match="bypass_imag_encoder"):
        JDuetModel(jcfg).bind({}).embeddings  # flax runs setup on first use
    cfg = dataclasses.replace(tiny_test_config("duet").model,
                              bypass_imag_encoder=False)
    with pytest.raises(ValueError, match="bypass_imag_encoder"):
        DuetModel(cfg)
