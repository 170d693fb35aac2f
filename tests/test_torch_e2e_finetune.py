"""`e2e_imagination` (the ViT in the fine-tune loop) of the port against the
JAX package's, on the CPU in f32 at the tiny config (ViT 16 px, patch 8, 2
layers, 4 heads), the JAX init carried into the port by the bridge:

- the HAMT teacher rollout in both modes: paths, logits, losses and the
  gradient of every parameter within 1e-4 (under 'frozen' the ViT's is
  zero in JAX, by stop_gradient, and absent in the port, by no_grad);
- one HAMT teacher train step under 'frozen' with AdamW weight decay: loss,
  grad_norm and every parameter against the JAX step; the ViT bitwise
  unchanged in both (optax `freeze_module` / no optimizer group), also
  over more port steps; under 'trainable' the ViT moves;
- the HAMT e2e greedy eval paths, identical;
- DUET's imagine mode (its e2e code) in both modes against JAX, output
  and every gradient, then a DAgger step: the ViT moves only if trainable;
- both raw banks against the JAX package's on the same .npy files;
- a train-CLI run on real-format files with `--e2e-imagination frozen
  --imagine-image-bank --imagine-image-index`: its episodes equal the JAX
  CLI's (images included), and the driver trains and checkpoints.
"""

import dataclasses
import json
import os
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.data import features as JF
from vln_imagine_tpu.envx import synthetic_episodes as j_episodes
from vln_imagine_tpu.envx import synthetic_world as j_world
from vln_imagine_tpu.train import trainer as j_trainer
from vln_imagine_tpu.train.rollout_hamt import rollout_hamt as j_rollout
from vln_imagine_tpu.train.trainer import HamtTrainer as JHamtTrainer
from vln_imagine_tpu_torch.ckpt.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from vln_imagine_tpu_torch.config import tiny_test_config
from vln_imagine_tpu_torch.data import features as F
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.models.hamt import HamtModel
from vln_imagine_tpu_torch.train.rollout_hamt import rollout_hamt
from vln_imagine_tpu_torch.train.trainer import HamtTrainer

torch.set_num_threads(2)

TOL = 1e-4
IMG = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _with(cfg, part, **kw):
    return dataclasses.replace(
        cfg, **{part: dataclasses.replace(getattr(cfg, part), **kw)})


def _cfg(tiny, agent, mode):
    """The tiny config with the ViT in the loop and plain AdamW (under the
    variant4 warm-up the ViT sits in the frozen "rest" group at step 0)
    with weight decay, which a frozen ViT must not feel."""
    cfg = _with(tiny(agent), "model", e2e_imagination=mode)
    return _with(cfg, "train", experimental_warmup=False, weight_decay=0.01,
                 lr=1e-2)


def _world_ep(world_fn, episodes_fn, cfg, batch=2):
    world, _ = world_fn(num_scans=1, num_nodes=14,
                        max_candidates=cfg.env.max_candidates,
                        views=cfg.env.views, feat_dim=cfg.model.image_feat_size,
                        seed=11)
    ep = episodes_fn(world, batch=batch, max_gt_path_len=cfg.env.max_gt_path_len,
                     max_instr_len=cfg.env.max_instr_len,
                     max_imaginations=cfg.model.max_imagination_len,
                     vocab_size=cfg.model.vocab_size,
                     feat_dim=cfg.model.hidden_size, seed=12,
                     imagine_image_size=IMG)
    return world, ep


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, np.asarray(v)


def _grads(model, agent):
    return dict(_leaves(flax_from_state_dict(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in model.named_parameters()}, agent)["params"]))


def _assert_grads(got, want_tree):
    want = dict(_leaves(want_tree["params"]))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=TOL,
                                   atol=TOL * max(1.0, np.abs(w).max()),
                                   err_msg=path)


_J_INIT = j_trainer._init_params


def _jit_init(model, cfg, tables, ep1, rng):
    """HamtTrainer.init_state's params, traced under jit (faster than the
    op-by-op init)."""
    return jax.jit(lambda r: _J_INIT(model, cfg, tables, ep1, r))(rng)


def _j_hamt_trainer(jcfg, jw, jep):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_trainer, "_init_params", _jit_init)
        jtr = JHamtTrainer(jcfg, jw, rng=jax.random.PRNGKey(42))
        return jtr, jtr.init_state(jep)


def _hamt_setup(mode):
    jcfg = _cfg(j_tiny_test_config, "hamt", mode)
    jw, jep = (jax.tree.map(jnp.asarray, x)
               for x in _world_ep(j_world, j_episodes, jcfg))
    jtr, state = _j_hamt_trainer(jcfg, jw, jep)
    cfg = _cfg(tiny_test_config, "hamt", mode)
    world, ep = _world_ep(synthetic_world, synthetic_episodes, cfg)
    return jtr, jcfg, jw, jep, state, cfg, world, ep


@pytest.fixture(scope="module")
def frozen():
    return _hamt_setup("frozen")


@pytest.mark.parametrize("mode", ["frozen", "trainable"])
def test_hamt_teacher_rollout_grads_match_jax(mode, frozen):
    jtr, jcfg, jw, jep, state, cfg, world, ep = frozen
    assert "imagine_vit" in state.params["params"]
    if mode == "trainable":  # the same weights, the other mode
        jcfg = _cfg(j_tiny_test_config, "hamt", mode)
        jtr = JHamtTrainer(jcfg, jw, rng=jax.random.PRNGKey(42))
        cfg = _cfg(tiny_test_config, "hamt", mode)
    model = HamtModel(cfg.model, feat_dropout=cfg.train.feat_dropout)
    model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, state.params)), strict=True)
    res = rollout_hamt(model, world.to("cpu"), ep.to("cpu"), cfg,
                       feedback="teacher", train_ml=1.0, deterministic=True)
    res.loss.backward()

    def loss_fn(params):
        r = j_rollout(jtr.model, jtr.critic, params, state.critic_params, jw,
                      jep, jcfg, jax.random.PRNGKey(7), feedback="teacher",
                      train_ml=1.0, train_rl=False, deterministic=True)
        return r.loss, r

    (_, jres), jgrad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params)
    np.testing.assert_array_equal(res.path_nodes.numpy(),
                                  np.asarray(jres.path_nodes))
    for name in ("loss", "ml_loss", "aux_loss", "logits"):
        np.testing.assert_allclose(getattr(res, name).detach().numpy(),
                                   np.asarray(getattr(jres, name)), rtol=TOL,
                                   atol=TOL, err_msg=name)
    got = _grads(model, "hamt")
    _assert_grads(got, jgrad)
    vit = [p for p in got if p.startswith("imagine_vit/")]
    assert vit
    moved = max(np.abs(got[p]).max() for p in vit)
    assert (moved > 0) == (mode == "trainable")
    if mode == "frozen":
        assert all(p.grad is None for p in model.imagine_vit.parameters())


class _NoDropout(flax.linen.Module):
    """flax.linen.Dropout's signature, the identity."""
    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


def _vit_state(model):
    return {k: v.clone() for k, v in model.imagine_vit.state_dict().items()}


def test_frozen_train_step_matches_jax(frozen, monkeypatch):
    """One teacher step with AdamW (weight decay 0.01): loss, grad_norm and
    every parameter against the JAX step (the alignment head's fixed 0.15
    dropout taken out of both, as tests/test_torch_train.py does); the ViT
    unchanged bitwise in both packages, and over two more port steps."""
    jtr, jcfg, jw, jep, state, cfg, world, ep = frozen
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    jtr, state = _j_hamt_trainer(jcfg, jw, jep)
    tr = HamtTrainer(cfg, world, device="cpu")
    tr.model.contrastive_alignment_model.image_proj.rate = 0.0
    tr.model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, state.params)), strict=True)
    assert not any(p is q for g in tr.optimizer.groups for p in g.params
                   for q in tr.model.imagine_vit.parameters())
    vit0 = _vit_state(tr.model)
    new, jm = jtr.make_train_step("teacher", donate=False)(
        state, jep, jep, jax.random.PRNGKey(0))
    m = tr.make_train_step("teacher")(ep, ep)
    for key in ("grad_norm", "loss", "ml_loss", "aux_loss"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4,
                                   err_msg=key)
    got = dict(_leaves(flax_from_state_dict(tr.model.state_dict())["params"]))
    want = dict(_leaves(new.params["params"]))
    init = dict(_leaves(state.params["params"]))
    moved = max(np.abs(want[p] - init[p]).max() for p in want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=1e-7 + 1e-2 * moved, err_msg=path)
        if path.startswith("imagine_vit/"):
            np.testing.assert_array_equal(want[path], init[path])
    step = tr.make_train_step("sample")
    for _ in range(2):
        step(ep, ep)
    for k, v in tr.model.imagine_vit.state_dict().items():
        assert torch.equal(v, vit0[k]), k


def test_trainable_vit_moves_with_the_navigator():
    cfg = _cfg(tiny_test_config, "hamt", "trainable")
    world, ep = _world_ep(synthetic_world, synthetic_episodes, cfg)
    tr = HamtTrainer(cfg, world, device="cpu")
    vit0 = _vit_state(tr.model)
    m = tr.make_train_step("sample")(ep, ep)
    assert torch.isfinite(m["loss"]) and m["grad_norm"] > 0
    assert any(not torch.equal(v, vit0[k])
               for k, v in tr.model.imagine_vit.state_dict().items())


def test_hamt_e2e_greedy_paths_match_jax(frozen):
    jtr, jcfg, jw, jep, state, cfg, world, ep = frozen
    tr = HamtTrainer(cfg, world, device="cpu")
    paths, lens = tr.make_eval_step()(ep)[:2]
    jpaths, jlens = jtr.make_eval_step()(
        flax_from_state_dict(tr.model.state_dict()), jep,
        jax.random.PRNGKey(0))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(paths.numpy(), np.asarray(jpaths))
    assert (lens.numpy() >= 1).all()


@pytest.mark.parametrize("mode", ["frozen", "trainable"])
def test_duet_e2e_imagine_mode_matches_jax(mode):
    """DUET's e2e code is its imagine mode: the ViT's class tokens into the
    imagination embeddings.  Its output and, under 'trainable', the
    gradient of every parameter against the JAX package's; then a port
    DAgger step under `mode`: finite, and the ViT moves only if trainable."""
    from vln_imagine_tpu.models.duet import DuetModel as JDuetModel
    from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

    cfg = _cfg(tiny_test_config, "duet", mode)
    jcfg = _cfg(j_tiny_test_config, "duet", mode)
    world, ep = _world_ep(synthetic_world, synthetic_episodes, cfg)
    tr = DuetTrainer(cfg, world, device="cpu")
    model = tr.model
    params = flax_from_state_dict(model.state_dict(), "duet")
    jmodel = JDuetModel(jcfg.model, feat_dropout=0.0)
    imgs = np.asarray(ep.imagine_images)
    w = np.random.default_rng(4).standard_normal(
        (2, cfg.model.max_imagination_len, cfg.model.hidden_size)
    ).astype(np.float32)

    def loss(p):
        out = jmodel.apply(p, jnp.asarray(imgs), method=JDuetModel.imagine)
        return jnp.sum(out * w), out

    (_, want), jgrad = jax.value_and_grad(loss, has_aux=True)(params)
    out = model.imagine(torch.from_numpy(imgs))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    if mode == "trainable":
        (out * torch.from_numpy(w)).sum().backward()
        got = _grads(model, "duet")
        _assert_grads(got, jgrad)
        assert max(np.abs(v).max() for p, v in got.items()
                   if p.startswith("imagine_vit/")) > 0
        model.zero_grad(set_to_none=True)
    else:
        assert not out.requires_grad or all(
            p.grad is None for p in model.imagine_vit.parameters())
    vit0 = _vit_state(model)
    m = tr.make_train_step()(ep, ep)
    assert torch.isfinite(m["loss"]) and m["grad_norm"] > 0
    moved = any(not torch.equal(v, vit0[k])
                for k, v in model.imagine_vit.state_dict().items())
    assert moved == (mode == "trainable")


def test_raw_banks_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    panos = rng.standard_normal((2, 3, 4, IMG, IMG, 3)).astype(np.float32)
    np.save(tmp_path / "panos.npy", panos)
    bank = F.RawPanoramaBank(str(tmp_path / "panos.npy"), IMG)
    jbank = JF.RawPanoramaBank(str(tmp_path / "panos.npy"), IMG)
    assert bank.shape == jbank.shape
    for key in ((1, 2, 3), (0, 1), (1,)):
        np.testing.assert_array_equal(bank[key], jbank[key])
    with pytest.raises(ValueError, match="expected"):
        F.RawPanoramaBank(str(tmp_path / "panos.npy"), IMG + 1)

    imgs = rng.standard_normal((7, IMG, IMG, 3)).astype(np.float32)
    np.save(tmp_path / "imag.npy", imgs)
    index = {"1_0": (0, 2), "1_1": (2, 3), "2_0": (3, 7)}
    flags = {"1_0": ["True", "False", "True"], "1_1": ["True"],
             "2_0": ["True", "True", "False", "True", "True"]}
    ids = ["1_0", "2_0", "1_1"]
    got = F.RawImaginationImageBank(str(tmp_path / "imag.npy"), index, IMG
                                    ).batch_images(ids, flags, 4)
    want = JF.RawImaginationImageBank(str(tmp_path / "imag.npy"), index, IMG
                                      ).batch_images(ids, flags, 4)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[1].any() and not got[1].all()


def test_cli_run_with_an_imagine_image_bank(tmp_path, monkeypatch):
    from tests.test_torch_train_cli import (
        _write_annotations,
        _write_connectivity,
        _write_features,
        _write_imagination,
    )
    from vln_imagine_tpu_torch.scripts import train as cli

    cfg = _cfg(tiny_test_config, "hamt", "frozen")
    world, graphs = synthetic_world(
        num_scans=2, num_nodes=12, max_candidates=cfg.env.max_candidates,
        views=cfg.env.views, feat_dim=cfg.model.image_feat_size, seed=0,
        with_features=False)
    ep = synthetic_episodes(
        world, batch=6, max_gt_path_len=cfg.env.max_gt_path_len,
        max_instr_len=cfg.env.max_instr_len, max_imaginations=3,
        vocab_size=cfg.model.vocab_size, feat_dim=cfg.model.hidden_size,
        seed=1)
    rng = np.random.default_rng(2)
    root = tmp_path / "files"
    paths = {k: str(root / v) for k, v in (
        ("conn", "connectivity"), ("anno", "annotations"),
        ("feat", "vit_features.hdf5"), ("imag", "imagine.hdf5"),
        ("flags", "generated_flags.json"), ("sub", "sub_instr.json"))}
    _write_connectivity(graphs, paths["conn"])
    ids = _write_annotations(graphs, ep, range(3), paths["anno"], "train", 0)
    val_ids = _write_annotations(graphs, ep, range(3, 6), paths["anno"],
                                 "val_unseen", 100)
    _write_features(graphs, paths["feat"], cfg.env.views,
                    cfg.model.image_feat_size, rng)
    _write_imagination(ids + val_ids, paths["imag"], paths["flags"],
                       paths["sub"], cfg.model.hidden_size, rng)
    # the raw images: one row per generated sub-instruction
    flags = json.loads(open(paths["flags"]).read())
    index, rows = {}, 0
    for iid in ids + val_ids:
        n = flags[iid].count("True")
        index[iid] = [rows, rows + n]
        rows += n
    np.save(root / "imag_images.npy", rng.standard_normal(
        (rows, IMG, IMG, 3)).astype(np.float32))
    (root / "imag_index.json").write_text(json.dumps(index))
    argv = ["--connectivity-dir", paths["conn"], "--anno-dir", paths["anno"],
            "--img-features", paths["feat"], "--generated-flag-file",
            paths["flags"], "--sub-instr-file", paths["sub"], "--splits",
            "train", "val_unseen", "--e2e-imagination", "frozen",
            "--imagine-image-bank", str(root / "imag_images.npy"),
            "--imagine-image-index", str(root / "imag_index.json")]

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import train as jcli

    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    jargs = jcli.parse_args()
    jcfg = _cfg(j_tiny_test_config, "hamt", "frozen")
    *_, jtrain, jvals, _, _ = jcli.build_real(jcfg, jargs)
    _, _, train, vals, _, _ = cli.build_real(cfg, cli.parse_args(argv))
    for split, jsplit in zip([train] + vals, [jtrain] + jvals, strict=True):
        for f in dataclasses.fields(jsplit.episodes):
            want = getattr(jsplit.episodes, f.name)
            got = getattr(split.episodes, f.name)
            if want is None:
                assert got is None, f.name
            else:
                np.testing.assert_array_equal(np.asarray(got),
                                              np.asarray(want), err_msg=f.name)
    assert np.asarray(train.episodes.imagine_images).any()

    # the tiny preset in place of the released one (off the card the CLI
    # keeps the dataset's preset for real data)
    monkeypatch.setattr(cli, "preset", lambda args, device: _with(
        tiny_test_config("hamt"), "train", experimental_warmup=False))
    log = tmp_path / "run"
    d = cli.main(argv + ["--iters", "2", "--log-every", "1", "--device", "cpu",
                         "--log-dir", str(log)])
    assert d.cfg.model.e2e_imagination == "frozen"
    assert hasattr(d.trainer.model, "imagine_vit")
    assert d.trainer.optimizer.steps == 2
    assert (log / "ckpts" / "latest_dict").exists()
    lines = (log / "train.txt").read_text()
    assert "iter 2" in lines and "nan" not in lines.lower()
