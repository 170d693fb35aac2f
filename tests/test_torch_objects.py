"""REVERIE / SOON objects in the port against the JAX package, in f32 on the
CPU at the tiny config with 32-d object features and 3 objects a node:

- `synthetic_world(max_objects=...)` and the episodes' `gt_obj_id` equal
  the JAX package's from the same seed;
- `observe_hamt`'s object segment (its own feature dim) and
  `observe_duet`'s object tokens (nav type 2) equal the JAX package's over
  a walk, exactly; the port's DUET observation carries the object features
  at their own width (`obj_img`), which the JAX package pads or truncates
  into the view features (`img`): padded or truncated alike, they are its;
- NavRef (`HamtModel` with objects): the language stack, the visual
  logits, states and `obj_logits`, with and without a visual-concat
  imagination (objects sit before it), within 1e-4;
- `DuetModel.navigation_per_step`'s `obj_logits`, within 1e-4;
- the bridge both ways from a JAX init: every flax leaf covered and equal.
  DUET with `obj_feat_size != image_feat_size` holds `obj_linear` /
  `obj_layer_norm`, which the JAX model creates and never applies (so its
  params lack them), and so does NavRef for its x-layers' language
  branches (its text skips the x-layers): they are the only keys the JAX
  init does not fill, and they cross the bridge back and forth unchanged.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_imagine_tpu.ckpt.convert import verify_converted
from vln_imagine_tpu.config import _replace as j_replace
from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.envx import env as j_envx
from vln_imagine_tpu.envx import synthetic_episodes as j_episodes
from vln_imagine_tpu.envx import synthetic_world as j_world
from vln_imagine_tpu.models.duet import DuetModel as JDuetModel
from vln_imagine_tpu.models.hamt import HamtModel as JHamtModel
from vln_imagine_tpu.train.trainer import _init_params as j_init_hamt
from vln_imagine_tpu.train.trainer_duet import _init_duet_params as j_init_duet
from vln_imagine_tpu_torch.ckpt.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from vln_imagine_tpu_torch.config import _replace, tiny_test_config
from vln_imagine_tpu_torch.envx import env as envx
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.models.duet import DuetModel
from vln_imagine_tpu_torch.models.hamt import HamtModel
from vln_imagine_tpu_torch.train.trainer import init_params

torch.set_num_threads(2)

TOL = 1e-4
KO, DO = 3, 32

# NavRef: no imagination (the released recipe), or a visual-concat one
NAVREF = {
    "navref": dict(imagine_enc_pano=False, use_cosine_aux_loss=False,
                   no_lang_ca=True, act_pred_token="ob_hist"),
    "navref_visual_imagine": dict(no_lang_ca=True, use_cosine_aux_loss=False,
                                  concat_imagine_with="visual"),
}


def _cfgs(agent, obj_feat_size=DO, **model):
    return tuple(
        dataclasses.replace(rep(tiny(agent), "model",
                                obj_feat_size=obj_feat_size, **model),
                            dataset="reverie")
        for tiny, rep in ((j_tiny_test_config, j_replace),
                          (tiny_test_config, _replace)))


def _world_ep(world_fn, episodes_fn, cfg, obj_dim=DO, batch=3):
    world, _ = world_fn(num_scans=1, num_nodes=14,
                        max_candidates=cfg.env.max_candidates,
                        views=cfg.env.views, feat_dim=cfg.model.image_feat_size,
                        seed=5, max_objects=KO, obj_feat_dim=obj_dim)
    ep = episodes_fn(world, batch=batch,
                     max_gt_path_len=cfg.env.max_gt_path_len,
                     max_instr_len=cfg.env.max_instr_len,
                     max_imaginations=cfg.model.max_imagination_len,
                     vocab_size=cfg.model.vocab_size,
                     feat_dim=cfg.model.hidden_size, seed=6)
    return world, ep


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, np.asarray(v)


# ------------------------------------------------------------------ tables
def test_object_world_and_targets_equal_jax():
    jcfg, cfg = _cfgs("duet")
    jw, jep = _world_ep(j_world, j_episodes, jcfg)
    w, ep = _world_ep(synthetic_world, synthetic_episodes, cfg)
    for name in ("obj_feat", "obj_ang", "obj_valid", "obj_ids", "obj_pos",
                 "feat", "adj"):
        np.testing.assert_array_equal(getattr(w, name), getattr(jw, name),
                                      err_msg=name)
    assert w.max_objects == jw.max_objects == KO
    for name in ("gt_obj_id", "start_heading", "gt_path", "txt_ids"):
        np.testing.assert_array_equal(getattr(ep, name), getattr(jep, name),
                                      err_msg=name)
    # some node has no object and some has all three: both paths are live
    n_obj = w.obj_valid.sum(-1)[w.node_valid]
    assert n_obj.min() == 0 and n_obj.max() == KO


@pytest.mark.parametrize("agent, obj_dim", [
    ("hamt", DO), ("duet", DO), ("duet", 24), ("duet", 40)])
def test_observe_with_objects_equals_jax(agent, obj_dim):
    """Three steps along candidate slot 0; DUET object features narrower
    and wider than the view features keep their own width in the port, and
    padded / truncated to the view width they are the JAX package's."""
    jcfg, cfg = _cfgs(agent)
    jw, jep = (jax.tree.map(jnp.asarray, x)
               for x in _world_ep(j_world, j_episodes, jcfg, obj_dim))
    w, ep = (x.to("cpu") for x in _world_ep(synthetic_world,
                                             synthetic_episodes, cfg, obj_dim))
    jst, st = j_envx.reset(jw, jep, 6), envx.reset(w, ep, 6)
    for _ in range(3):
        if agent == "hamt":
            jo, o = j_envx.observe_hamt(jw, jep, jst), envx.observe_hamt(w, ep, st)
            names = ("img", "ang", "nav_types", "valid", "obj_img", "obj_ang",
                     "obj_ids", "obj_valid", "obj_pos")
            assert o.obj_img.shape[-1] == obj_dim
        else:
            jo, o = j_envx.observe_duet(jw, jep, jst), envx.observe_duet(w, ep, st)
            names = ("img", "loc", "nav_types", "valid", "obj_ids",
                     "obj_valid")
            K, V = w.max_candidates, w.views
            assert o.img.shape[1] == K + V and o.nav_types.shape[1] == K + V + KO
            assert o.obj_img.shape == (ep.batch, KO, obj_dim)
            np.testing.assert_array_equal(o.nav_types[:, K + V:] == 2,
                                          o.obj_valid)
            Df = o.img.shape[-1]
            fit = (torch.nn.functional.pad(o.obj_img, (0, Df - obj_dim))
                   if obj_dim < Df else o.obj_img[..., :Df])
            o = o._replace(img=torch.cat([o.img, fit], 1))
        for name in names:
            np.testing.assert_allclose(getattr(o, name).numpy(),
                                       np.asarray(getattr(jo, name)),
                                       rtol=0, atol=1e-6, err_msg=name)
        a = torch.zeros(ep.batch, dtype=torch.int32)
        jst = j_envx.step_hamt(jw, jep, jst, jnp.zeros(ep.batch, jnp.int32))
        st = envx.step_hamt(w, ep, st, a)


# ------------------------------------------------------------------ models
def _navref_inputs(mcfg, seed=0):
    rng = np.random.default_rng(seed)
    B, L, I, T_HIST, T_OBS = 3, 16, 4, 5, 20
    H, Df, A = mcfg.hidden_size, mcfg.image_feat_size, mcfg.angle_feat_size
    txt_mask = np.arange(L)[None] < np.array([16, 9, 12])[:, None]
    nav = rng.integers(0, 3, (B, T_OBS)).astype(np.int32)
    obj_valid = np.array([[1, 1, 0], [1, 0, 0], [0, 0, 0]], bool)
    return dict(
        txt_ids=np.where(txt_mask, rng.integers(4, mcfg.vocab_size, (B, L)),
                         0).astype(np.int32),
        txt_mask=txt_mask,
        txt_embeds=rng.standard_normal(
            (1 + mcfg.num_x_layers, B, L, H)).astype(np.float32),
        imagine=rng.standard_normal((B, I, H)).astype(np.float32),
        imagine_mask=np.array([[1, 1, 0, 1], [1, 0, 0, 0], [1, 1, 1, 1]],
                              bool),
        hist=rng.standard_normal((B, T_HIST, H)).astype(np.float32),
        hist_mask=np.arange(T_HIST)[None] < np.array([[5], [2], [1]]),
        ob_img=rng.standard_normal((B, T_OBS, Df)).astype(np.float32),
        ob_ang=rng.standard_normal((B, T_OBS, A)).astype(np.float32),
        ob_nav=nav,
        ob_valid=(rng.random((B, T_OBS)) < 0.8) | (nav == 2),
        obj_img=(rng.standard_normal((B, KO, DO))
                 * obj_valid[..., None]).astype(np.float32),
        obj_ang=rng.standard_normal((B, KO, A)).astype(np.float32),
        obj_pos=rng.random((B, KO, 5)).astype(np.float32),
        # the last item has no valid object: its obj logits are all masked
        obj_valid=obj_valid,
    )


@pytest.mark.parametrize("variant", list(NAVREF))
def test_navref_modes_match_jax(variant):
    jcfg, cfg = _cfgs("hamt", **NAVREF[variant])
    port = HamtModel(cfg.model).eval()
    init_params(port, torch.Generator().manual_seed(5))
    assert hasattr(port, "obj_embeddings") and hasattr(port, "ref_object")
    params = flax_from_state_dict(port.state_dict())
    jm = JHamtModel(jcfg.model, feat_dropout=jcfg.train.feat_dropout)
    x = _navref_inputs(cfg.model)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    j = {k: jnp.asarray(v) for k, v in x.items()}

    def japply(method, *a, **kw):
        return jm.apply(params, *a, method=method, deterministic=True, **kw)

    imag = cfg.model.imagine_enc_pano
    with torch.no_grad():
        lang = port.language(t["txt_ids"], t["txt_mask"])
        out = port.visual(
            t["txt_embeds"], t["txt_mask"], t["hist"], t["hist_mask"],
            t["ob_img"], t["ob_ang"], t["ob_nav"], t["ob_valid"],
            imagine_embeds=t["imagine"] if imag else None,
            imagine_mask=t["imagine_mask"] if imag else None,
            obj_img_feats=t["obj_img"], obj_ang_feats=t["obj_ang"],
            obj_valid=t["obj_valid"], obj_pos_feats=t["obj_pos"])
    jlang = japply(JHamtModel.language, j["txt_ids"], j["txt_mask"])
    jout = japply(JHamtModel.visual, j["txt_embeds"], j["txt_mask"],
                  j["hist"], j["hist_mask"], j["ob_img"], j["ob_ang"],
                  j["ob_nav"], j["ob_valid"],
                  imagine_embeds=j["imagine"] if imag else None,
                  imagine_mask=j["imagine_mask"] if imag else None,
                  obj_img_feats=j["obj_img"], obj_ang_feats=j["obj_ang"],
                  obj_valid=j["obj_valid"], obj_pos_feats=j["obj_pos"])
    # NavRef's language: the final text in every slot of the stack
    assert lang.shape[0] == 1 + cfg.model.num_x_layers
    np.testing.assert_array_equal(lang[0].numpy(), lang[-1].numpy())
    np.testing.assert_allclose(lang.numpy(), np.asarray(jlang), rtol=TOL,
                               atol=TOL, err_msg="language")
    for name in ("act_logits", "txt_embeds", "hist_embeds", "ob_embeds",
                 "state", "obj_logits"):
        g, w = getattr(out, name).numpy(), np.asarray(getattr(jout, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)
    # masked objects are out of the grounding head's reach
    assert (out.obj_logits.numpy()[~x["obj_valid"]] < -1e8).all()
    assert np.isfinite(out.obj_logits.numpy()[x["obj_valid"]]).all()


def test_duet_navigation_obj_logits_match_jax():
    jcfg, cfg = _cfgs("duet")
    port = DuetModel(cfg.model).eval()
    init_params(port, torch.Generator().manual_seed(7))
    params = flax_from_state_dict(port.state_dict(), "duet")
    jm = JDuetModel(jcfg.model, feat_dropout=jcfg.train.feat_dropout)
    rng = np.random.default_rng(3)
    B, L, G, Tp, H, I = 2, 10, 5, 12, cfg.model.hidden_size, 4
    A = cfg.model.angle_feat_size
    vp_obj = np.zeros((B, Tp + 1), bool)
    vp_obj[0, -KO:] = [True, True, False]  # item 1: every object masked
    x = [rng.standard_normal((B, L, H)), np.arange(L)[None] < [[10], [6]],
         rng.standard_normal((B, G + 1, H)),
         rng.integers(0, 5, (B, G + 1)).astype(np.int32),
         rng.standard_normal((B, G + 1, A + 3)), np.ones((B, G + 1), bool),
         rng.random((B, G + 1, G + 1)), np.zeros((B, G + 1), bool),
         rng.standard_normal((B, Tp + 1, H)), rng.standard_normal((B, Tp + 1, 14)),
         np.ones((B, Tp + 1), bool), rng.random((B, Tp + 1)) < 0.5,
         rng.random((B, G + 1, Tp + 1)) < 0.2]
    x = [a.astype(np.float32) if a.dtype == np.float64 else a for a in x]
    imag = rng.standard_normal((B, I, H)).astype(np.float32)
    imask = np.array([[1, 1, 0, 0], [1, 0, 0, 0]], bool)
    with torch.no_grad():
        out = port.navigation_per_step(
            *[torch.from_numpy(a) for a in x],
            imagine_embeds=torch.from_numpy(imag),
            imagine_mask=torch.from_numpy(imask),
            vp_obj_valid=torch.from_numpy(vp_obj))
    jout = jm.apply(params, *[jnp.asarray(a) for a in x],
                    imagine_embeds=jnp.asarray(imag),
                    imagine_mask=jnp.asarray(imask),
                    vp_obj_valid=jnp.asarray(vp_obj), deterministic=True,
                    method=JDuetModel.navigation_per_step)
    for name in ("obj_logits", "fused_logits", "vp_embeds"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)
    assert (out.obj_logits.numpy()[~vp_obj] < -1e8).all()


# ------------------------------------------------------------------ bridge
def _jax_init(agent, jcfg, jw, jep):
    if agent == "hamt":
        model = JHamtModel(jcfg.model, feat_dropout=jcfg.train.feat_dropout)
        init = j_init_hamt
    else:
        model = JDuetModel(jcfg.model, feat_dropout=jcfg.train.feat_dropout)
        init = j_init_duet
    return jax.tree.map(np.asarray, jax.jit(
        lambda r: init(model, jcfg, jw, jep, r))(jax.random.PRNGKey(42)))


@pytest.mark.parametrize("agent, model_kw, obj_dim", [
    pytest.param("hamt", NAVREF["navref"], DO, id="navref"),
    pytest.param("hamt", NAVREF["navref_visual_imagine"], DO,
                 id="navref_visual_imagine"),
    pytest.param("duet", {}, DO, id="reverie_duet"),
    pytest.param("duet", {}, 24, id="reverie_duet_unused_obj_linear"),
])
def test_jax_init_crosses_the_bridge_both_ways(agent, model_kw, obj_dim):
    jcfg, cfg = _cfgs(agent, obj_feat_size=obj_dim, **model_kw)
    jw, jep = (jax.tree.map(jnp.asarray, x) for x in _world_ep(
        j_world, j_episodes, jcfg, obj_dim, batch=1))
    params = _jax_init(agent, jcfg, jw, jep)
    port = (HamtModel if agent == "hamt" else DuetModel)(cfg.model)
    result = port.load_state_dict(state_dict_from_flax(params, agent),
                                  strict=False)
    assert not result.unexpected_keys
    # what the JAX model creates and never applies has no flax params:
    # DUET's obj_linear / obj_layer_norm at obj_feat_size != image_feat_size,
    # and NavRef's x-layer language branches (its text skips the x-layers)
    unused = re.compile(
        r"img_embeddings\.obj_(linear|layer_norm)\.(weight|bias)"
        if agent == "duet" else
        r"encoder\.x_layers\.\d+\.lang_(self_att|inter|output)\..*")
    want_missing = {k for k in port.state_dict() if unused.fullmatch(k)}
    assert bool(want_missing) == (
        obj_dim != cfg.model.image_feat_size if agent == "duet"
        else cfg.model.obj_feat_size > 0)
    assert set(result.missing_keys) == want_missing
    back = flax_from_state_dict(port.state_dict(), agent)
    assert verify_converted(back, params) == []
    got, want = dict(_leaves(back["params"])), dict(_leaves(params["params"]))
    assert len(set(got) - set(want)) == len(want_missing)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    # the object leaves are there, and the unused ones go back unchanged
    heads = ("obj_embeddings/", "ref_object/") if agent == "hamt" \
        else ("og_head/",)
    assert any(p.startswith(heads) for p in want)
    again = state_dict_from_flax(back, agent)
    sd = port.state_dict()
    assert set(again) == set(sd)
    for k in sd:
        torch.testing.assert_close(again[k], sd[k], rtol=0, atol=0)
