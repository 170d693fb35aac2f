"""DUET pre-training of the port (pretrain/duet_data.py, duet_model.py,
trainer.py's `DuetPretrainer`, the `duet_pretrain` bridge) against the JAX
package's, on the CPU in f32 at the tiny config:

- the mlm / mrc / sap batches, and og's on a world with objects, bitwise
  from one seed (and through the native prefetching bank);
- `CrossmodalEncoder.lang2visn_stack` alone, and the pano encoder over
  padding steps whose keys are all masked at -1e9;
- each task's loss, count, correct count and the gradient of every
  parameter within 1e-4, the JAX init carried into the port by the bridge,
  which covers every leaf of the model at each task set (the leaf set
  follows the tasks, as flax creates a parameter at its first use);
- the decayed parameters of `pretrain_optimizer`;
- the batcher over the native feature bank;
- the transfer of a snapshot into DUET fine-tuning.

The pre-trainer's loop against the JAX one (gradient accumulation,
`validate`) is in tests/test_torch_duet_pretrain_trainer.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_imagine_tpu.ckpt import convert as JC
from vln_imagine_tpu.ckpt.transfer import (
    init_finetune_from_pretrain as j_transfer,
)
from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.models.duet import CrossmodalEncoder as JCrossmodal
from vln_imagine_tpu.pretrain import duet_data as JD
from vln_imagine_tpu.pretrain.duet_model import DuetPretrainModel as JModel
from vln_imagine_tpu.train.optim import pretrain_optimizer as j_pretrain_opt
from vln_imagine_tpu_torch import native
from vln_imagine_tpu_torch.ckpt.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from vln_imagine_tpu_torch.config import _replace, tiny_test_config
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.models.duet import CrossmodalEncoder
from vln_imagine_tpu_torch.pretrain import duet_data as D
from vln_imagine_tpu_torch.pretrain.duet_model import DuetPretrainModel
from vln_imagine_tpu_torch.pretrain.trainer import (
    DUET_TASK_ARGS,
    DuetPretrainer,
)
from vln_imagine_tpu_torch.train.optim import (
    no_decay_parameter,
    pretrain_optimizer,
)
from vln_imagine_tpu_torch.train.trainer import init_params
from tests.test_torch_pretrain import _assert_batches_equal, _leaves

torch.set_num_threads(2)

TOL = 1e-4
P = 8  # image_prob_size
THREE = ("mlm", "mrc", "sap")
FOUR = THREE + ("og",)
OBJECTS = 6  # objects a node in the world with objects


def _episodes(world, batch, seed):
    cfg = tiny_test_config("duet")
    return synthetic_episodes(
        world, batch=batch, max_gt_path_len=cfg.env.max_gt_path_len,
        max_instr_len=cfg.env.max_instr_len,
        max_imaginations=cfg.model.max_imagination_len,
        vocab_size=cfg.model.vocab_size, feat_dim=cfg.model.hidden_size,
        seed=seed)


def _world_ep(seed=0, batch=6, objects=0):
    cfg = tiny_test_config("duet")
    world, _ = synthetic_world(
        num_scans=2, num_nodes=12, max_candidates=cfg.env.max_candidates,
        views=cfg.env.views, feat_dim=cfg.model.image_feat_size, seed=seed,
        max_objects=objects)
    return world, _episodes(world, batch, seed + 1)


def _batcher_kw(cfg, seed=9):
    return dict(max_hist_len=cfg.env.max_action_len,
                max_gmap_nodes=cfg.env.max_gmap_nodes,
                angle_feat_size=cfg.model.angle_feat_size, image_prob_size=P,
                vocab_size=cfg.model.vocab_size, seed=seed)


def _lang2visn(cfg):
    return dataclasses.replace(cfg.model, use_lang2visn_attn=True)


@pytest.mark.parametrize("objects", [0, OBJECTS], ids=["r2r", "objects"])
def test_task_batches_are_bitwise_the_jax_ones(objects):
    cfg = tiny_test_config("duet")
    world, ep = _world_ep(objects=objects)
    port = D.DuetTrajectoryBatcher(world, ep, **_batcher_kw(cfg))
    jax_ = JD.DuetTrajectoryBatcher(world, ep, **_batcher_kw(cfg))
    tasks = FOUR if objects else THREE
    for task, bs in [(t, 2) for t in tasks] + [(t, 5) for t in tasks] + [
            ("mlm", 3), (tasks[-1], 1)]:
        _assert_batches_equal(port.task_batch(task, bs),
                              jax_.task_batch(task, bs), task)
    idx = np.array([3, 0, 5])
    _assert_batches_equal(port.mlm_batch(idx, mlm_prob=0.5),
                          jax_.mlm_batch(idx, mlm_prob=0.5), "mlm_prob")
    if objects:  # some item grounds a visible object
        assert (port.task_batch("og", 6)["obj_labels"] >= 0).any()


@functools.lru_cache(maxsize=None)
def _models(tasks: tuple, objects: int = 0):
    """The JAX package's DuetPretrainModel for `tasks` with the shapes of
    its init (every task's forward traced once), the port model with its
    own seeded init, those weights as JAX params (through the bridge), and
    one batch per task."""
    jcfg, cfg = j_tiny_test_config("duet"), tiny_test_config("duet")
    world, ep = _world_ep(objects=objects)
    batcher = D.DuetTrajectoryBatcher(world, ep, **_batcher_kw(cfg, seed=4))
    # og: six items, so that some end where the target object shows
    batches = {t: batcher.task_batch(t, 6 if t == "og" else 3)
               for t in tasks}
    jmodel = JModel(_lang2visn(jcfg), image_prob_size=P, tasks=tasks)

    def init_all(mdl):
        for t, b in batches.items():
            getattr(mdl, f"forward_{t}")(
                *(jnp.asarray(b[k]) for k in DUET_TASK_ARGS[t]))

    shapes = jax.eval_shape(lambda r: jmodel.init(r, method=init_all),
                            jax.random.PRNGKey(0))
    port = DuetPretrainModel(_lang2visn(cfg), image_prob_size=P, tasks=tasks)
    init_params(port, torch.Generator().manual_seed(len(tasks) + objects))
    params = flax_from_state_dict(port.state_dict(), "duet_pretrain")
    return jmodel, shapes, params, port, batches


TASK_SETS = [pytest.param(("mlm",), 0, id="mlm"),
             pytest.param(("mrc",), 0, id="mrc"),
             pytest.param(THREE, 0, id="mlm-mrc-sap"),
             pytest.param(FOUR, OBJECTS, id="mlm-mrc-sap-og")]


@pytest.mark.parametrize("tasks, objects", TASK_SETS)
def test_bridge_covers_every_leaf(tasks, objects):
    """Both ways: the port's weights as JAX params fill exactly the JAX
    init's leaves with its shapes, and come back bitwise."""
    _, shapes, params, port, _ = _models(tasks, objects)
    assert JC.verify_converted(params, shapes) == []
    got = {p: v.shape for p, v in _leaves(params["params"])}
    want = {"/".join(k.key for k in p): v.shape
            for p, v in jax.tree_util.tree_leaves_with_path(
                shapes["params"])}
    assert got == want
    back = state_dict_from_flax(params, "duet_pretrain")
    assert back.keys() == port.state_dict().keys()
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k
    names = [n for n, _ in port.named_parameters()]
    assert "bert.embeddings.word_embeddings.weight" in names
    assert not any("decoder" in n for n in names)  # tied: one Parameter
    # the language side only with MLM, the visual side only without it alone
    assert any(".lang_self_att." in n for n in names) == ("mlm" in tasks)
    assert any(".visn_self_att." in n for n in names) == (tasks != ("mlm",))


@pytest.mark.parametrize("task, tasks, objects", [
    ("mlm", THREE, 0), ("mrc", THREE, 0), ("sap", THREE, 0),
    ("og", FOUR, OBJECTS)])
def test_task_loss_and_grads_match_jax(task, tasks, objects):
    jmodel, _, params, port, batches = _models(tasks, objects)
    batch = batches[task]

    def loss_fn(p):
        s, n, c = jmodel.apply(p, *(jnp.asarray(batch[k])
                                    for k in DUET_TASK_ARGS[task]),
                               method=getattr(JModel, f"forward_{task}"))
        return s / jnp.maximum(n, 1), (s, n, c)

    (_, (js, jn, jc)), jgrad = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    port.zero_grad(set_to_none=True)
    s, n, c = getattr(port, f"forward_{task}")(
        *(torch.as_tensor(np.asarray(batch[k])) for k in DUET_TASK_ARGS[task]))
    (s / max(int(n), 1)).backward()
    np.testing.assert_allclose(float(s.detach()), float(js), rtol=TOL,
                               atol=TOL)
    assert int(n) == int(jn) > 0 and int(c) == int(jc)
    assert float(s.detach()) > 0
    got = dict(_leaves(flax_from_state_dict(
        {k: (p.grad if p.grad is not None else torch.zeros_like(p))
         for k, p in port.named_parameters()}, "duet_pretrain")["params"]))
    want = dict(_leaves(jgrad["params"]))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=TOL,
                                   atol=TOL * max(1.0, np.abs(w).max()),
                                   err_msg=f"{task} {path}")
    if task == "sap":  # the graph bias trains sprel_linear through dBias
        assert np.abs(want["sprel_linear/kernel"]).max() > 0
    if task in ("mrc", "og"):  # the global branch is not read
        assert not any(np.abs(w).max() for p, w in want.items()
                       if p.startswith("global_encoder/"))


def test_lang2visn_stack_matches_jax():
    """The language stream queried through a branch's layers: outputs
    and the gradient of every layer parameter and of the text input."""
    jcfg, cfg = j_tiny_test_config("duet"), tiny_test_config("duet")
    H = cfg.model.hidden_size
    rng = np.random.default_rng(3)
    txt = rng.standard_normal((2, 9, H)).astype(np.float32)
    img = rng.standard_normal((2, 7, H)).astype(np.float32)
    txt_mask = np.arange(9)[None] < np.array([[9], [5]])
    img_mask = np.arange(7)[None] < np.array([[4], [7]])
    w = rng.standard_normal((2, 9, H)).astype(np.float32)
    jenc = JCrossmodal(_lang2visn(jcfg))
    args = (txt, txt_mask, img, img_mask)
    params = jax.tree.map(np.asarray, jax.jit(lambda r: jenc.init(
        r, *args, method=JCrossmodal.lang2visn_stack))(jax.random.PRNGKey(1)))

    def f(p, t):
        out = jenc.apply(p, t, txt_mask, img, img_mask,
                         method=JCrossmodal.lang2visn_stack)
        return jnp.sum(out * w), out

    (_, jout), (jgp, jgt) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, txt)
    enc = CrossmodalEncoder(cfg.model, lang=True, visn=False)
    prefix = "local_encoder.encoder."
    sd = state_dict_from_flax({"local_encoder": params["params"]}, "duet")
    enc.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                        strict=True)
    t = torch.tensor(txt, requires_grad=True)
    out = enc.lang2visn_stack(t, torch.tensor(txt_mask), torch.tensor(img),
                              torch.tensor(img_mask))
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t.grad.numpy(), jgt, rtol=TOL, atol=TOL)
    got = dict(_leaves(flax_from_state_dict(
        {prefix + k: p.grad for k, p in enc.named_parameters()},
        "duet")["params"]["local_encoder"]))
    want = dict(_leaves(jgp["params"]))
    assert set(got) == set(want) and any(".lang_" in n for n, _ in
                                         enc.named_parameters())
    for path, g in want.items():
        np.testing.assert_allclose(got[path], g, rtol=TOL,
                                   atol=TOL * max(1.0, np.abs(g).max()),
                                   err_msg=path)


def test_pano_encoder_over_padding_steps_matches_jax():
    """The pano encoder over whole end-aligned trajectories: the rows of
    the padding steps have every key masked at -1e9, where s - max is 0 on
    every key and the weights are uniform; outputs and gradients as JAX's
    in f32."""
    from vln_imagine_tpu.models.bert import PreNormEncoder as JPreNorm
    from vln_imagine_tpu_torch.models.bert import PreNormEncoder

    jcfg, cfg = j_tiny_test_config("duet"), tiny_test_config("duet")
    H, rows, L = cfg.model.hidden_size, 12, 9
    rng = np.random.default_rng(11)
    x = rng.standard_normal((rows, L, H)).astype(np.float32)
    valid = rng.random((rows, L)) < 0.7
    valid[:2 * rows // 3] = False  # padding steps
    w = rng.standard_normal((rows, L, H)).astype(np.float32)
    jenc = JPreNorm(jcfg.model, jcfg.model.num_pano_layers)
    params = jax.tree.map(np.asarray, jax.jit(lambda r: jenc.init(
        r, x, valid))(jax.random.PRNGKey(2)))

    def f(p, t):
        out = jenc.apply(p, t, valid)
        return jnp.sum(out * w), out

    (_, jout), (jgp, jgt) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, x)
    prefix = "img_embeddings.pano_encoder."
    sd = state_dict_from_flax({"pano_encoder": params["params"]}, "duet")
    enc = PreNormEncoder(cfg.model, cfg.model.num_pano_layers)
    enc.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                        strict=True)
    t = torch.tensor(x, requires_grad=True)
    out = enc(t, torch.tensor(valid))
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t.grad.numpy(), jgt, rtol=TOL, atol=TOL)
    got = dict(_leaves(flax_from_state_dict(
        {prefix + k: p.grad for k, p in enc.named_parameters()},
        "duet")["params"]["pano_encoder"]))
    want = dict(_leaves(jgp["params"]))
    assert set(got) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path], g, rtol=TOL,
                                   atol=TOL * max(1.0, np.abs(g).max()),
                                   err_msg=path)


@pytest.mark.parametrize("tasks, objects", [TASK_SETS[1], TASK_SETS[2]])
def test_decayed_parameters_are_the_jax_ones(tasks, objects):
    """Two updates with no gradient (the first at lr 0): only weight decay
    moves a parameter, so the moved set is each optimizer's decayed set.
    The port's parameters have no gradient at all, as those of a branch
    the task does not read (the global encoder under mrc)."""
    _, _, params, port, _ = _models(tasks, objects)
    tx = j_pretrain_opt(1e-2, 1, 10)
    state = tx.init(params)
    jp = params
    update = jax.jit(tx.update)
    for _ in range(2):
        upd, state = update(jax.tree.map(jnp.zeros_like, jp), state, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, upd)
    after = dict(_leaves(jp["params"]))
    j_moved = {p for p, a in _leaves(params["params"])
               if not np.array_equal(a, after[p])}

    model = DuetPretrainModel(_lang2visn(tiny_test_config("duet")),
                              image_prob_size=P, tasks=tasks)
    model.load_state_dict(port.state_dict())
    opt = pretrain_optimizer(model, 1e-2, 1, 10)
    before = flax_from_state_dict(
        {k: v.clone() for k, v in model.state_dict().items()},
        "duet_pretrain")
    for _ in range(2):
        opt.step()
    after = flax_from_state_dict(model.state_dict(), "duet_pretrain")
    after = dict(_leaves(after["params"]))
    moved = {p for p, a in _leaves(before["params"])
             if not np.array_equal(a, after[p])}
    assert moved == j_moved
    for path in ("embeddings/word_embeddings/embedding",
                 "pano_encoder/layer_0/self_attn/query/kernel",
                 "global_encoder/x_layer_0/visual_attention/att/key/kernel",
                 "sprel_linear/kernel"):
        assert path in moved, path
    assert not any(p.endswith(("/bias", "/scale")) for p in moved)
    assert no_decay_parameter(
        model, "bert.img_embeddings.pano_encoder.layers.0.self_attn."
        "in_proj_bias")
    assert no_decay_parameter(
        model, "bert.img_embeddings.pano_encoder.layers.0.norm1.weight")


def test_prefetch_batcher_matches_synchronous(tmp_path):
    """The batcher over the native bank (one gather in flight) gives the
    synchronous batcher's batches, and the JAX package's, across batch-size
    changes; the pre-trainer takes it when given a bank."""
    cfg = tiny_test_config("duet")
    world, ep = _world_ep(seed=5, objects=OBJECTS)
    feat = np.asarray(world.feat)
    bank = native.FeatureBank.write(str(tmp_path / "bank.f32"),
                                    feat.reshape(-1, feat[0, 0].size))
    kw = _batcher_kw(cfg)
    sync = D.DuetTrajectoryBatcher(world, ep, **kw)
    jsync = JD.DuetTrajectoryBatcher(world, ep, **kw)
    pref = D.PrefetchDuetTrajectoryBatcher(world, ep, bank, **kw)
    assert pref.w["feat"] is None
    for task, bs in [("mlm", 2), ("mrc", 2), ("sap", 2), ("og", 2),
                     ("mlm", 4), ("sap", 4), ("og", 3)]:
        a, b, c = (x.task_batch(task, bs) for x in (sync, pref, jsync))
        assert pref._pending is not None
        _assert_batches_equal(a, b, f"prefetch {task}")
        _assert_batches_equal(a, c, f"jax {task}")
    pt = DuetPretrainer(_replace(cfg, "pretrain", tasks=THREE,
                                 mix_ratio=(1, 1, 1)), world, ep,
                        image_prob_size=P, feature_bank=bank, device="cpu")
    assert isinstance(pt.batcher, D.PrefetchDuetTrajectoryBatcher)
    state, summary = pt.train(pt.init_state(), 3, batch_size=2)
    assert state.step == 3 and all(np.isfinite(v) for v in summary.values())


def test_transfer_to_finetune_matches_jax(tmp_path):
    """A port snapshot grafted by `FinetuneDriver.init_from_pretrain`, read
    through the duet_pretrain bridge: the JAX package's transfer of the same
    pre-trained weights into the same fine-tune init gives the same count
    and the same fine-tune parameters."""
    from tests.test_torch_driver import _driver
    from vln_imagine_tpu_torch.pretrain.trainer import PretrainState

    cfg = _replace(tiny_test_config("duet"), "pretrain", tasks=THREE,
                   mix_ratio=(1, 1, 1))
    world, ep = _world_ep(seed=3)
    pt = DuetPretrainer(cfg, world, ep, image_prob_size=P, device="cpu")
    path = pt.save(PretrainState(7), str(tmp_path))
    d = _driver(tmp_path / "ft", agent="duet")
    ft0 = flax_from_state_dict(d.trainer.model.state_dict(), "duet")
    pt_flax = flax_from_state_dict(pt.model.state_dict(), "duet_pretrain")
    info = d.init_from_pretrain(path)
    want, n, missing = j_transfer(ft0, pt_flax)
    assert info["transferred"] == n > 0
    assert info["missing"] == missing
    got = dict(_leaves(flax_from_state_dict(d.trainer.model.state_dict(),
                                            "duet")["params"]))
    for p, w in _leaves(want["params"]):
        np.testing.assert_array_equal(got[p], w, err_msg=p)
    # the SAP heads and the backbone move; the lang side has no place
    assert ("global_sap_head/dense0/kernel", "not in pretrain") not in missing
    assert not any("lang_self_att" in p for p in got)
