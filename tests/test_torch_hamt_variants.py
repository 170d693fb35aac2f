"""The HAMT model variants of the training recipe's ablations, in the port
against the JAX package, in f32 on the CPU at the tiny config:

- the full imagination encoder (`bypass_imag_encoder=False`), with an item
  that has no imagination (every key of its rows masked);
- `no_lang_ca` (the text is not updated by the cross-modal layers; the
  language mode returns one static text per layer; critic state hist[CLS]),
  with visual-concatenated imagination and no alignment loss, and its
  refusal of language-concatenated imagination;
- the InfoNCE and margin alignment losses inside the train step;
- `act_pred_token="ob_imagine_text"`, with language- and visual-concat
  imagination.

For each: the modes it changes against `HamtModel.apply` (same weights
through the bridge, same numpy inputs), a JAX init that loads strict into
the port and round-trips exactly with every flax leaf covered
(`verify_converted`), and two `make_train_step("teacher")` steps against
the JAX step.  Tolerances as tests/test_torch_hamt.py and
tests/test_torch_train.py.
"""

import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_imagine_tpu.ckpt.convert import verify_converted
from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.envx import synthetic_episodes as j_episodes
from vln_imagine_tpu.envx import synthetic_world as j_world
from vln_imagine_tpu.models.hamt import HamtModel as JHamtModel
from vln_imagine_tpu.train.trainer import HamtTrainer as JHamtTrainer
from vln_imagine_tpu.train.trainer import _init_params
from vln_imagine_tpu_torch.ckpt.convert import (
    critic_state_dict_from_flax,
    flax_from_state_dict,
    state_dict_from_flax,
)
from vln_imagine_tpu_torch.config import tiny_test_config
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.models.hamt import HamtModel
from vln_imagine_tpu_torch.train.trainer import HamtTrainer, init_params

torch.set_num_threads(2)

TOL = 1e-4

VARIANTS = {
    "full_imagine_encoder": dict(bypass_imag_encoder=False),
    "no_lang_ca": dict(no_lang_ca=True, concat_imagine_with="visual",
                       use_cosine_aux_loss=False),
    "infonce": dict(aux_loss_type="infonce"),
    "margin": dict(aux_loss_type="margin"),
    # the head ob * (txt[CLS] + mean(imagination outputs)): the language
    # stream's imagination tokens, or under visual concat the embeddings
    "ob_imagine_text": dict(act_pred_token="ob_imagine_text"),
    "ob_imagine_text_visual": dict(act_pred_token="ob_imagine_text",
                                   concat_imagine_with="visual",
                                   use_cosine_aux_loss=False),
}
MODEL_VARIANTS = ("full_imagine_encoder", "no_lang_ca", "ob_imagine_text",
                  "ob_imagine_text_visual")
STEP_VARIANTS = ("full_imagine_encoder", "no_lang_ca", "infonce", "margin")


def _with(cfg, part, **kw):
    return dataclasses.replace(
        cfg, **{part: dataclasses.replace(getattr(cfg, part), **kw)})


def _cfgs(variant):
    return (_with(j_tiny_test_config("hamt"), "model", **VARIANTS[variant]),
            _with(tiny_test_config("hamt"), "model", **VARIANTS[variant]))


def _world_ep(world_fn, episodes_fn, cfg, batch=3):
    world, _ = world_fn(num_scans=1, num_nodes=14,
                        max_candidates=cfg.env.max_candidates,
                        views=cfg.env.views, feat_dim=cfg.model.image_feat_size,
                        seed=11)
    ep = episodes_fn(world, batch=batch, max_gt_path_len=cfg.env.max_gt_path_len,
                     max_instr_len=cfg.env.max_instr_len,
                     max_imaginations=cfg.model.max_imagination_len,
                     vocab_size=cfg.model.vocab_size,
                     feat_dim=cfg.model.hidden_size, seed=12)
    # the last item has no imagination: every key of its rows is masked
    ep.imagine_mask[-1] = False
    return world, ep


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, np.asarray(v)


# ------------------------------------------------------------------ modes
def _inputs(mcfg, stack):
    rng = np.random.default_rng(0)
    B, L, I, T_HIST, T_OBS = 3, 16, 4, 5, 20
    H, Df, A = mcfg.hidden_size, mcfg.image_feat_size, mcfg.angle_feat_size
    txt_mask = np.arange(L)[None] < np.array([16, 9, 12])[:, None]
    nav = rng.integers(0, 3, (B, T_OBS)).astype(np.int32)
    txt_shape = ((1 + mcfg.num_x_layers,) if stack else ()) + (B, L, H)
    return dict(
        txt_ids=np.where(txt_mask, rng.integers(4, mcfg.vocab_size, (B, L)),
                         0).astype(np.int32),
        txt_mask=txt_mask,
        txt_embeds=rng.standard_normal(txt_shape).astype(np.float32),
        imagine_feats=rng.standard_normal((B, I, H)).astype(np.float32),
        imagine_mask=np.array([[1, 1, 0, 1], [1, 0, 0, 0], [0, 0, 0, 0]],
                              bool),
        hist_embeds=rng.standard_normal((B, T_HIST, H)).astype(np.float32),
        hist_mask=np.arange(T_HIST)[None] < np.array([[5], [2], [1]]),
        ob_img=rng.standard_normal((B, T_OBS, Df)).astype(np.float32),
        ob_ang=rng.standard_normal((B, T_OBS, A)).astype(np.float32),
        ob_nav=nav,
        ob_valid=(rng.random((B, T_OBS)) < 0.8) | (nav == 2),
    )


def _mode(mode, model, x, params=None):
    if params is not None:
        c, M = jnp.asarray, JHamtModel

        def call(method, *args, **kw):
            return model.apply(params, *args, method=method,
                               deterministic=True, **kw)
    else:
        M = HamtModel

        def c(a):
            return torch.from_numpy(np.asarray(a))

        def call(method, *args, **kw):
            with torch.no_grad():
                return method(model, *args, **kw)
    if mode == "language":
        return [call(M.language, c(x["txt_ids"]), c(x["txt_mask"]))]
    if mode == "imagine":
        return [call(M.imagine, c(x["imagine_feats"]), c(x["imagine_mask"]))]
    out = call(M.visual, c(x["txt_embeds"]), c(x["txt_mask"]),
               c(x["hist_embeds"]), c(x["hist_mask"]), c(x["ob_img"]),
               c(x["ob_ang"]), c(x["ob_nav"]), c(x["ob_valid"]),
               imagine_embeds=c(x["imagine_feats"]),
               imagine_mask=c(x["imagine_mask"]))
    return [out.act_logits, out.txt_embeds, out.hist_embeds, out.ob_embeds,
            out.state]


@pytest.mark.parametrize("mode", ["language", "imagine", "visual"])
@pytest.mark.parametrize("variant", MODEL_VARIANTS)
def test_mode_matches_jax(variant, mode):
    jcfg, pcfg = _cfgs(variant)
    port = HamtModel(pcfg.model).eval()
    init_params(port, torch.Generator().manual_seed(5))
    params = flax_from_state_dict(port.state_dict())
    jmodel = JHamtModel(jcfg.model, feat_dropout=jcfg.train.feat_dropout)
    x = _inputs(pcfg.model, stack=pcfg.model.no_lang_ca)
    got, want = _mode(mode, port, x), _mode(mode, jmodel, x, params)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, (mode, i)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg=f"{variant} {mode} output {i}")
    if variant == "no_lang_ca" and mode == "language":
        assert got[0].shape[0] == 1 + pcfg.model.num_x_layers
    if variant == "no_lang_ca" and mode == "visual":
        # the text passes the x-layers unchanged: the last layer's static text
        np.testing.assert_array_equal(got[1].numpy(),
                                      x["txt_embeds"][-2])
        np.testing.assert_array_equal(got[4].numpy(), got[2].numpy()[:, 0])


def test_no_lang_ca_refuses_language_concat_imagination():
    cfg = _with(tiny_test_config("hamt"), "model", no_lang_ca=True)
    model = HamtModel(cfg.model).eval()
    x = _inputs(cfg.model, stack=True)
    with pytest.raises(ValueError, match="no_lang_ca"):
        _mode("visual", model, x)


# ----------------------------------------------------------------- bridge
@pytest.mark.parametrize("variant", MODEL_VARIANTS)
def test_jax_init_loads_strict_and_round_trips(variant):
    jcfg, pcfg = _cfgs(variant)
    jw, jep = (jax.tree.map(jnp.asarray, x)
               for x in _world_ep(j_world, j_episodes, jcfg, batch=1))
    model = JHamtModel(jcfg.model, feat_dropout=jcfg.train.feat_dropout)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda r: _init_params(model, jcfg, jw, jep, r))(jax.random.PRNGKey(42)))
    port = HamtModel(pcfg.model)
    sd = state_dict_from_flax(params)
    result = port.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    back = flax_from_state_dict(port.state_dict())
    assert verify_converted(back, params) == []
    got, want = dict(_leaves(back["params"])), dict(_leaves(params["params"]))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    if variant == "full_imagine_encoder":
        assert any(p.startswith("imagine_embeddings/pano_encoder/") for p in want)


# ------------------------------------------------------------- train step
class _NoDropout(flax.linen.Module):
    """flax.linen.Dropout's signature, the identity."""
    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.mark.parametrize("variant", STEP_VARIANTS)
def test_teacher_train_steps_match_jax(variant, monkeypatch):
    """Two teacher steps (stage 1, then the lagged stage 2 with stage ends 1
    and 2) from the JAX init, every dropout out of both packages: loss,
    grad_norm and every parameter, as tests/test_torch_train.py."""
    jcfg, pcfg = _cfgs(variant)
    jcfg = _with(jcfg, "train", warmup_stage1_iters=1, warmup_stage2_iters=2)
    pcfg = _with(pcfg, "train", warmup_stage1_iters=1, warmup_stage2_iters=2)
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    jw, jep = (jax.tree.map(jnp.asarray, x)
               for x in _world_ep(j_world, j_episodes, jcfg))
    jtr = JHamtTrainer(jcfg, jw, rng=jax.random.PRNGKey(42))
    state = jtr.init_state(jep)
    jstep = jtr.make_train_step("teacher", donate=False)

    world, ep = _world_ep(synthetic_world, synthetic_episodes, pcfg)
    tr = HamtTrainer(pcfg, world, device="cpu")
    if pcfg.model.use_cosine_aux_loss:
        tr.model.contrastive_alignment_model.image_proj.rate = 0.0
    tr.model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, state.params)), strict=True)
    tr.critic.load_state_dict(critic_state_dict_from_flax(
        jax.tree.map(np.asarray, state.critic_params)), strict=True)
    step = tr.make_train_step("teacher")
    init = dict(_leaves(state.params["params"]))
    for i in range(2):
        state, jm = jstep(state, jep, jep, jax.random.PRNGKey(i))
        m = step(ep, ep)
        for key in ("grad_norm", "loss", "ml_loss", "aux_loss"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i} {key}")
        if pcfg.model.use_cosine_aux_loss:
            assert float(m["aux_loss"]) > 0
        got = dict(_leaves(flax_from_state_dict(tr.model.state_dict())["params"]))
        want = dict(_leaves(state.params["params"]))
        moved = max(np.abs(want[p] - init[p]).max() for p in want)
        assert moved > 0
        for path in want:
            np.testing.assert_allclose(got[path], want[path], rtol=0,
                                       atol=1e-7 + 1e-2 * moved,
                                       err_msg=f"{variant} step {i} {path}")
