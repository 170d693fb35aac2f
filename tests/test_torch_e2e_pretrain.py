"""E2E image pre-training of the port (pretrain/hamt_e2e.py, the ViT in the
step) against the JAX package's, on the CPU in f32 at the tiny config with
a tiny ViT (16 px, patch 8, width 32 = the image feature width, 4 heads):

- the six tasks' batches from `E2EImageBatcher`, bitwise against the JAX
  batcher's over one in-memory panorama bank;
- each task's loss, counts and the gradient of every parameter (the ViT's
  included) within 1e-4, the JAX init carried into the port by the bridge;
- the ViT's gradient comes only from the history views and the
  observations: the panorama pass runs without autograd (each ViT call is
  recorded), the panorama pixels get no gradient and the view pixels do.

The tasks without observation tokens (mlm, mrc, itm) run here, sap, sar and
sprel in tests/test_torch_e2e_pretrain_obs.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.models.vit import ViTConfig as JViTConfig
from vln_imagine_tpu.pretrain import data as JD
from vln_imagine_tpu.pretrain.hamt_e2e import HamtE2EPretrainModel as JModel
from vln_imagine_tpu.pretrain.trainer import E2E_TASK_ARGS as J_ARGS
from vln_imagine_tpu_torch.ckpt.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from vln_imagine_tpu_torch.config import tiny_test_config
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.models.vit import ViTConfig
from vln_imagine_tpu_torch.pretrain import data as D
from vln_imagine_tpu_torch.pretrain.hamt_e2e import HamtE2EPretrainModel
from vln_imagine_tpu_torch.pretrain.trainer import E2E_TASK_ARGS

torch.set_num_threads(2)

TOL = 1e-4
P = 8
VIT = dict(image_size=16, patch_size=8, hidden_size=32, num_layers=1,
           num_heads=4, compute_dtype="float32")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, np.asarray(v)


# the tasks without observation tokens here, sap / sar / sprel in
# tests/test_torch_e2e_pretrain_obs.py (one worker's file each)
FILE_TASKS = ("mlm", "mrc", "itm")


def make_setup(tasks):
    """Both packages' batches of `tasks` (checked bitwise), the JAX init of
    a model with their heads (traced under jit) and the port model holding
    it."""
    cfg = tiny_test_config("hamt")
    world, _ = synthetic_world(num_scans=2, num_nodes=10,
                               max_candidates=cfg.env.max_candidates,
                               views=cfg.env.views,
                               feat_dim=cfg.model.image_feat_size, seed=0)
    ep = synthetic_episodes(world, batch=5,
                            max_gt_path_len=cfg.env.max_gt_path_len,
                            max_instr_len=cfg.env.max_instr_len,
                            max_imaginations=cfg.model.max_imagination_len,
                            vocab_size=cfg.model.vocab_size,
                            feat_dim=cfg.model.hidden_size, seed=1)
    S, N, V = np.asarray(world.feat).shape[:3]
    images = np.random.default_rng(2).standard_normal(
        (S, N, V, 16, 16, 3)).astype(np.float32)
    kw = dict(max_hist_len=cfg.env.max_action_len,
              angle_feat_size=cfg.model.angle_feat_size, image_prob_size=P,
              vocab_size=cfg.model.vocab_size, seed=3)
    port_b = D.E2EImageBatcher(world, ep, images, **kw)
    jax_b = JD.E2EImageBatcher(world, ep, images, **kw)
    batches = {}
    for t in tasks:
        a, b = port_b.task_batch(t, 2), jax_b.task_batch(t, 2)
        assert set(a) == set(b), t
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{t}/{k}")
        batches[t] = a
    jmodel = JModel(j_tiny_test_config("hamt").model,
                    vit_config=JViTConfig(**VIT), image_prob_size=P,
                    tasks=tasks)

    def init_all(mdl):
        for t, b in batches.items():
            getattr(mdl, f"forward_{t}")(*(jnp.asarray(b[k])
                                           for k in J_ARGS[t]))

    params = jax.tree.map(np.asarray, jax.jit(
        lambda r: jmodel.init(r, method=init_all))(jax.random.PRNGKey(0)))
    port = HamtE2EPretrainModel(cfg.model, vit_config=ViTConfig(**VIT),
                                image_prob_size=P, tasks=tasks)
    # flax creates a module's parameters at its first use: without an
    # observation task the JAX model has no img_embeddings
    missing, unexpected = port.load_state_dict(
        state_dict_from_flax(params, "hamt_e2e_pretrain"), strict=False)
    assert not unexpected and all(
        k.startswith("head_model.img_embeddings.") for k in missing)
    return jmodel, params, port, batches


@pytest.fixture(scope="module")
def setup():
    return make_setup(FILE_TASKS)


def test_bridge_covers_every_leaf(setup):
    from vln_imagine_tpu.ckpt.convert import verify_converted

    _, params, port, _ = setup
    back = flax_from_state_dict(port.state_dict(), "hamt_e2e_pretrain")
    assert verify_converted(back, params) == []
    assert set(back["params"]) == {"vit", "head_model"}


@pytest.mark.parametrize("task", FILE_TASKS)
def test_e2e_task_loss_and_grads_match_jax(setup, task):
    check_task(setup, task)


def check_task(setup, task):
    jmodel, params, port, batches = setup
    batch = batches[task]

    def loss_fn(p):
        s, n, c = jmodel.apply(p, *(jnp.asarray(batch[k])
                                    for k in J_ARGS[task]),
                               method=getattr(JModel, f"forward_{task}"))
        return s / jnp.maximum(n, 1), (s, n, c)

    (_, (js, jn, jc)), jgrad = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    port.zero_grad(set_to_none=True)
    calls = []
    forward = port.vit.forward

    def recorded(images):
        calls.append((images.shape[0], torch.is_grad_enabled()))
        return forward(images)

    port.vit.forward = recorded
    try:
        args = {k: torch.as_tensor(np.asarray(batch[k]))
                for k in E2E_TASK_ARGS[task]}
        for k in ("hist_images", "hist_pano_images"):
            args[k].requires_grad_(True)
        s, n, c = getattr(port, f"forward_{task}")(*args.values())
        (s / max(int(n), 1)).backward()
    finally:
        del port.vit.forward
    np.testing.assert_allclose(float(s.detach()), float(js), rtol=TOL,
                               atol=TOL)
    assert int(n) == int(jn)
    # ITM's correct count is an argmax over candidates that can be equal: an
    # order-shuffled negative of a history of one step is the positive, so
    # rounding picks the winner; its loss is compared above
    if task != "itm":
        assert int(c) == int(jc)
    got = dict(_leaves(flax_from_state_dict(
        {k: (p.grad if p.grad is not None else torch.zeros_like(p))
         for k, p in port.named_parameters()}, "hamt_e2e_pretrain")["params"]))
    want = dict(_leaves(jgrad["params"]))
    # only the unused observation embeddings are absent from the JAX tree
    extra = set(got) - set(want)
    assert set(want) <= set(got) and all(
        p.startswith("head_model/img_embeddings/") and not got[p].any()
        for p in extra)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=TOL,
                                   atol=TOL * max(1.0, np.abs(w).max()),
                                   err_msg=f"{task} {path}")
    has_hist = bool(np.asarray(batch["hist_masks"])[:, 1:].any())
    if task != "mrc" and (has_hist or "ob_images" in E2E_TASK_ARGS[task]):
        assert max(np.abs(v).max() for p, v in got.items()
                   if p.startswith("vit/")) > 0
    # views (with autograd), panoramas (without), then the observations
    B, T = batch["hist_masks"].shape[0], batch["hist_masks"].shape[1] - 1
    V = batch["hist_pano_images"].shape[2]
    want_calls = [(B * T, True), (B * T * V, False)]
    if "ob_images" in E2E_TASK_ARGS[task]:
        want_calls.append((B * batch["ob_images"].shape[1], True))
    assert calls == want_calls
    assert args["hist_pano_images"].grad is None
    if task != "mrc" and has_hist:  # MRC zeroes the masked steps' features
        assert args["hist_images"].grad.abs().max() > 0
