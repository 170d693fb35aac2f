"""Every HamtModel mode of the port against `HamtModel.apply` of the JAX
package, with the same weights (the port's seeded init carried across by
the bridge) and the same numpy inputs, in float32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.models.hamt import HamtModel as JHamtModel
from vln_imagine_tpu_torch.ckpt.convert import flax_from_state_dict
from vln_imagine_tpu_torch.config import tiny_test_config
from vln_imagine_tpu_torch.models.hamt import HamtModel
from vln_imagine_tpu_torch.train.trainer import init_params

torch.set_num_threads(2)

TOL = 1e-4  # tests/test_reference_parity_hamt.py:45

B, L, I, T_HIST, T_OBS = 3, 16, 4, 5, 20


@pytest.fixture(scope="module")
def models():
    pcfg = tiny_test_config("hamt")
    port = HamtModel(pcfg.model).eval()
    init_params(port, torch.Generator().manual_seed(5))
    params = flax_from_state_dict(port.state_dict())
    jcfg = j_tiny_test_config("hamt")
    jmodel = JHamtModel(jcfg.model, feat_dropout=jcfg.train.feat_dropout)
    return port, jmodel, params, pcfg.model


def _inputs(mcfg):
    rng = np.random.default_rng(0)
    H, Df, A = mcfg.hidden_size, mcfg.image_feat_size, mcfg.angle_feat_size
    txt_len = np.array([16, 9, 12])
    txt_mask = np.arange(L)[None] < txt_len[:, None]
    imagine_mask = np.array([[1, 1, 0, 1], [1, 0, 0, 0], [0, 0, 0, 0]], bool)
    np_w = np.zeros((B, I, L), np.float32)
    np_w[0, 0, 2:4] = 0.5
    np_w[0, 1, 6] = 1.0
    np_w[1, 0, 3:6] = 1 / 3
    nav = rng.integers(0, 3, (B, T_OBS)).astype(np.int32)
    return dict(
        txt_ids=np.where(txt_mask, rng.integers(4, mcfg.vocab_size, (B, L)), 0
                         ).astype(np.int32),
        txt_mask=txt_mask,
        txt_embeds=rng.standard_normal((B, L, H)).astype(np.float32),
        imagine_feats=rng.standard_normal((B, I, H)).astype(np.float32),
        imagine_mask=imagine_mask,
        np_weights=np_w,
        hist_img=rng.standard_normal((B, Df)).astype(np.float32),
        prev_ang=rng.standard_normal((B, A)).astype(np.float32),
        pano_img=rng.standard_normal((B, 12, Df)).astype(np.float32),
        pano_ang=rng.standard_normal((B, 12, A)).astype(np.float32),
        hist_embeds=rng.standard_normal((B, T_HIST, H)).astype(np.float32),
        hist_mask=np.arange(T_HIST)[None] < np.array([[5], [2], [1]]),
        ob_img=rng.standard_normal((B, T_OBS, Df)).astype(np.float32),
        ob_ang=rng.standard_normal((B, T_OBS, A)).astype(np.float32),
        ob_nav=nav,
        ob_valid=(rng.random((B, T_OBS)) < 0.8) | (nav == 2),
    )


def _run(mode, model, x, jax_side, params=None):
    """Call one mode on either side with the same numpy inputs."""
    if jax_side:
        c = jnp.asarray

        def call(method, *args, **kw):
            return model.apply(params, *args, method=method,
                               deterministic=True, **kw)
        M = JHamtModel
    else:
        def c(a):
            return torch.from_numpy(np.asarray(a))

        def call(method, *args, **kw):
            with torch.no_grad():
                return method(model, *args, **kw)
        M = HamtModel
    if mode == "language":
        return [call(M.language, c(x["txt_ids"]), c(x["txt_mask"]))]
    if mode == "history_initial":
        return [call(M.history_initial, B)]
    if mode == "history_step":
        return [call(M.history_step, c(x["hist_img"]), c(x["prev_ang"]), 3,
                     c(x["pano_img"]), c(x["pano_ang"]))]
    if mode == "imagine":
        return [call(M.imagine, c(x["imagine_feats"]), c(x["imagine_mask"]))]
    if mode == "align_with_contrastive_loss":
        loss, new = call(M.align_with_contrastive_loss, c(x["txt_embeds"]),
                         c(x["txt_mask"]), c(x["imagine_feats"]),
                         c(x["imagine_mask"]), c(x["np_weights"]))
        return [loss, new]
    if mode == "visual":
        out = call(M.visual, c(x["txt_embeds"]), c(x["txt_mask"]),
                   c(x["hist_embeds"]), c(x["hist_mask"]), c(x["ob_img"]),
                   c(x["ob_ang"]), c(x["ob_nav"]), c(x["ob_valid"]),
                   imagine_embeds=c(x["imagine_feats"]),
                   imagine_mask=c(x["imagine_mask"]))
        return [out.act_logits, out.txt_embeds, out.hist_embeds,
                out.ob_embeds, out.state]
    raise ValueError(mode)


MODES = ["language", "history_initial", "history_step", "imagine",
         "align_with_contrastive_loss", "visual"]


@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_jax(models, mode):
    port, jmodel, params, mcfg = models
    x = _inputs(mcfg)
    got = _run(mode, port, x, jax_side=False)
    want = _run(mode, jmodel, x, jax_side=True, params=params)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, (mode, i)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg=f"{mode} output {i}")
    if mode == "align_with_contrastive_loss":
        # the overwrite: valid rows carry the projection, the rest the input
        valid = x["imagine_mask"] & (x["np_weights"].sum(-1) > 0)
        new = got[1].numpy()
        np.testing.assert_array_equal(new[~valid], x["imagine_feats"][~valid])
        assert not np.allclose(new[valid], x["imagine_feats"][valid])
        assert float(got[0]) > 0.0
