"""HAMT pre-training of the port (pretrain/data.py, hamt_model.py,
trainer.py; train/optim.py's `pretrain_optimizer`) against the JAX
package's, on the CPU in f32 at the tiny config:

- the six task batches, bitwise, from one seed (and the batcher's index
  stream across batch-size changes); the MetaSampler's task sequence;
- each task's loss, count, correct count and the gradient of every
  parameter of HamtPretrainModel within 1e-4, the JAX init carried into
  the port by the bridge, which covers every leaf of the model (the heads
  the fine-tune bridge skips included);
- the warm-up-linear schedule's values, and the set of decayed parameters
  (found by each package's own optimizer: two updates of zero gradients
  move exactly the decayed ones);
- the transfer into fine-tuning (`FinetuneDriver.init_from_pretrain`)
  against the JAX package's `init_finetune_from_pretrain`, and the BERT
  on-ramp (`load_pretrain_init`) against the JAX one; a save / resume
  round trip.

The pre-trainer's loop against the JAX one (gradient accumulation,
`validate`) is in tests/test_torch_pretrain_trainer.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_imagine_tpu.ckpt import convert as JC
from vln_imagine_tpu.ckpt.manager import load_pretrain_init as j_load_init
from vln_imagine_tpu.ckpt.transfer import (
    init_finetune_from_pretrain as j_transfer,
)
from vln_imagine_tpu.config import _replace as j_replace
from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.pretrain import data as JD
from vln_imagine_tpu.pretrain.hamt_model import HamtPretrainModel as JModel
from vln_imagine_tpu.pretrain.trainer import TASK_ARGS as J_TASK_ARGS
from vln_imagine_tpu.train.optim import pretrain_optimizer as j_pretrain_opt
from vln_imagine_tpu.train.optim import warmup_linear_schedule as j_sched
from vln_imagine_tpu_torch.ckpt.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from vln_imagine_tpu_torch.ckpt.manager import load_pretrain_init
from vln_imagine_tpu_torch.config import _replace, tiny_test_config
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.pretrain import data as D
from vln_imagine_tpu_torch.pretrain.hamt_model import TASKS, HamtPretrainModel
from vln_imagine_tpu_torch.pretrain.trainer import TASK_ARGS, HamtPretrainer
from vln_imagine_tpu_torch.train.optim import (
    no_decay_parameter,
    pretrain_optimizer,
    warmup_linear_schedule,
)

torch.set_num_threads(2)

TOL = 1e-4
P = 8  # image_prob_size


def _world_ep(seed=0, batch=6, world_fn=synthetic_world,
              episodes_fn=synthetic_episodes, ep_seed=None):
    cfg = tiny_test_config("hamt")
    world, _ = world_fn(num_scans=2, num_nodes=12,
                               max_candidates=cfg.env.max_candidates,
                               views=cfg.env.views,
                               feat_dim=cfg.model.image_feat_size, seed=seed)
    ep = episodes_fn(world, batch=batch,
                     max_gt_path_len=cfg.env.max_gt_path_len,
                     max_instr_len=cfg.env.max_instr_len,
                     max_imaginations=cfg.model.max_imagination_len,
                     vocab_size=cfg.model.vocab_size,
                     feat_dim=cfg.model.hidden_size,
                     seed=seed + 1 if ep_seed is None else ep_seed)
    return world, ep


def _j_world_ep(seed=0, batch=6, ep_seed=None):
    """The same world and episodes from the JAX package's generator, as
    device arrays."""
    from vln_imagine_tpu.envx import synthetic_episodes as j_episodes
    from vln_imagine_tpu.envx import synthetic_world as j_world

    return (jax.tree.map(jnp.asarray, x)
            for x in _world_ep(seed, batch, j_world, j_episodes, ep_seed))


def _batcher_kw(cfg, seed=9):
    return dict(max_hist_len=cfg.env.max_action_len,
                angle_feat_size=cfg.model.angle_feat_size, image_prob_size=P,
                vocab_size=cfg.model.vocab_size, seed=seed)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, np.asarray(v)


def _assert_batches_equal(a, b, what):
    assert set(a) == set(b), (what, set(a) ^ set(b))
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}/{k}")


def test_task_batches_are_bitwise_the_jax_ones():
    cfg = tiny_test_config("hamt")
    world, ep = _world_ep()
    port = D.TrajectoryBatcher(world, ep, **_batcher_kw(cfg))
    jax_ = JD.TrajectoryBatcher(world, ep, **_batcher_kw(cfg))
    for task, bs in [("mlm", 2), ("sap", 3), ("sar", 3), ("sprel", 2),
                     ("mrc", 4), ("itm", 5), ("mlm", 4), ("itm", 1)]:
        _assert_batches_equal(port.task_batch(task, bs),
                              jax_.task_batch(task, bs), task)
    idx = np.array([3, 0, 5])
    _assert_batches_equal(port.base_batch(idx, end_step=True),
                          jax_.base_batch(idx, end_step=True), "end_step")


def test_meta_sampler_sequence():
    mix = (5, 1, 1, 1, 2, 2)
    port = D.MetaSampler(TASKS, mix, seed=3)
    jax_ = JD.MetaSampler(TASKS, mix, seed=3)
    seq = [port.draw() for _ in range(200)]
    assert seq == [jax_.draw() for _ in range(200)]
    assert set(seq) == set(TASKS)


@pytest.fixture(scope="module")
def models():
    """The JAX init of HamtPretrainModel (every task's forward traced once,
    under jit), the port model holding it, and one batch per task."""
    jcfg, cfg = j_tiny_test_config("hamt"), tiny_test_config("hamt")
    world, ep = _world_ep()
    batcher = D.TrajectoryBatcher(world, ep, **_batcher_kw(cfg, seed=4))
    batches = {t: batcher.task_batch(t, 3) for t in TASKS}
    jmodel = JModel(jcfg.model, image_prob_size=P)

    def init_all(mdl):
        for t, b in batches.items():
            getattr(mdl, f"forward_{t}")(
                *(jnp.asarray(b[k]) for k in J_TASK_ARGS[t]))

    params = jax.tree.map(np.asarray, jax.jit(
        lambda r: jmodel.init(r, method=init_all))(jax.random.PRNGKey(0)))
    port = HamtPretrainModel(cfg.model, image_prob_size=P)
    port.load_state_dict(state_dict_from_flax(params, "hamt_pretrain"),
                         strict=True)
    return jmodel, params, port, batches, cfg


def test_bridge_covers_every_leaf(models):
    jmodel, params, port, _, _ = models
    back = flax_from_state_dict(port.state_dict(), "hamt_pretrain")
    assert JC.verify_converted(back, params) == []
    got, want = dict(_leaves(back["params"])), dict(_leaves(params["params"]))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    # the MLM decoder is the word embedding: one Parameter
    names = [n for n, _ in port.named_parameters()]
    assert "embeddings.word_embeddings.weight" in names
    assert not any("decoder" in n for n in names)


@pytest.mark.parametrize("task", TASKS)
def test_task_loss_and_grads_match_jax(models, task):
    jmodel, params, port, batches, _ = models
    batch = batches[task]

    def loss_fn(p):
        s, n, c = jmodel.apply(p, *(jnp.asarray(batch[k])
                                    for k in J_TASK_ARGS[task]),
                               method=getattr(JModel, f"forward_{task}"))
        return s / jnp.maximum(n, 1), (s, n, c)

    (_, (js, jn, jc)), jgrad = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    port.zero_grad(set_to_none=True)
    s, n, c = getattr(port, f"forward_{task}")(
        *(torch.as_tensor(np.asarray(batch[k])) for k in TASK_ARGS[task]))
    (s / max(int(n), 1)).backward()
    np.testing.assert_allclose(float(s.detach()), float(js), rtol=TOL,
                               atol=TOL)
    assert int(n) == int(jn) and int(c) == int(jc)
    assert float(s.detach()) > 0
    got = dict(_leaves(flax_from_state_dict(
        {k: (p.grad if p.grad is not None else torch.zeros_like(p))
         for k, p in port.named_parameters()}, "hamt_pretrain")["params"]))
    want = dict(_leaves(jgrad["params"]))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=TOL,
                                   atol=TOL * max(1.0, np.abs(w).max()),
                                   err_msg=f"{task} {path}")
    assert max(np.abs(w).max() for w in want.values()) > 0


def test_schedule_values_match_jax():
    port, jax_ = warmup_linear_schedule(1e-3, 10, 40), j_sched(1e-3, 10, 40)
    for c in (0, 1, 5, 9, 10, 11, 25, 39, 40, 41, 100):
        np.testing.assert_allclose(port(c), float(jax_(c)), rtol=1e-7,
                                   atol=0, err_msg=str(c))
    assert port(0) == 0.0 and port(50) == 0.0


def test_decayed_parameters_are_the_jax_ones(models):
    """Two updates of zero gradients (the first at lr 0): only weight decay
    moves a parameter, so the moved set is each optimizer's decayed set."""
    jmodel, params, port, _, _ = models
    tx = j_pretrain_opt(1e-2, 1, 10)
    state = tx.init(params)
    jp = params
    update = jax.jit(tx.update)
    for _ in range(2):
        upd, state = update(jax.tree.map(jnp.zeros_like, jp), state, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, upd)
    j_moved = {p for (p, a), (_, b) in zip(_leaves(params["params"]),
                                            _leaves(jp["params"]))
               if not np.array_equal(a, b)}

    model = HamtPretrainModel(tiny_test_config("hamt").model,
                              image_prob_size=P)
    model.load_state_dict(port.state_dict())
    opt = pretrain_optimizer(model, 1e-2, 1, 10)
    before = flax_from_state_dict(
        {k: v.clone() for k, v in model.state_dict().items()}, "hamt_pretrain")
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()
    after = flax_from_state_dict(model.state_dict(), "hamt_pretrain")
    moved = {p for (p, a), (_, b) in zip(_leaves(before["params"]),
                                          _leaves(after["params"]))
             if not np.array_equal(a, b)}
    assert moved == j_moved
    assert any(p.endswith("/kernel") for p in moved)
    assert not any(p.endswith(("/bias", "/scale")) for p in moved)
    assert no_decay_parameter(model, "mlm_head.predictions.bias")
    assert no_decay_parameter(model, "encoder.layer.0.output.LayerNorm.weight")
    assert not no_decay_parameter(model, "embeddings.word_embeddings.weight")


def _pretrain_cfgs(**over):
    """The tiny config's pre-training part for a short run, in both
    packages."""
    over = dict(dict(tasks=("mlm", "sap"), mix_ratio=(1, 1), lr=1e-3,
                     warmup_steps=1, num_train_steps=10, batch_size=2,
                     seed=5), **over)
    return (j_replace(j_tiny_test_config("hamt"), "pretrain", **over),
            _replace(tiny_test_config("hamt"), "pretrain", **over))


def test_transfer_to_finetune_matches_jax(tmp_path):
    """A port snapshot grafted by `init_from_pretrain`: the same leaf count
    and the same fine-tune parameters as the JAX package's transfer of the
    same pre-trained weights into the same fine-tune init."""
    from tests.test_torch_driver import _driver
    from vln_imagine_tpu_torch.pretrain.trainer import PretrainState

    cfg = tiny_test_config("hamt")
    world, ep = _world_ep(seed=3)
    pt = HamtPretrainer(cfg, world, ep, image_prob_size=P, device="cpu")
    path = pt.save(PretrainState(7), str(tmp_path))
    d = _driver(tmp_path / "ft")
    ft0 = flax_from_state_dict(d.trainer.model.state_dict())
    info = d.init_from_pretrain(path)
    want, n, missing = j_transfer(
        ft0, flax_from_state_dict(pt.model.state_dict(), "hamt_pretrain"))
    assert info["transferred"] == n > 0
    assert info["missing"] == missing
    got = dict(_leaves(flax_from_state_dict(d.trainer.model.state_dict())[
        "params"]))
    for p, w in _leaves(want["params"]):
        np.testing.assert_array_equal(got[p], w, err_msg=p)
    np.testing.assert_array_equal(
        got["next_action/dense0/kernel"],
        pt.model.next_action.net["0"].weight.detach().numpy().T)


def test_bert_init_matches_jax(tmp_path, models):
    """`load_pretrain_init` (source 'bert'): a Hugging Face BERT layout
    (`bert.*` and `cls.predictions.*` keys) grafted into the pre-training
    model as the JAX package grafts it; the DUET sources load
    (tests/test_torch_duet_pretrain_init.py holds them against the JAX
    package), LXMERT for DUET alone."""
    jmodel, params, port, _, _ = models
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in port.state_dict().items():
        if k.startswith(("embeddings.", "encoder.layer.")):
            sd[f"bert.{k}"] = torch.from_numpy(
                rng.standard_normal(v.shape).astype(np.float32))
        elif k.startswith("mlm_head."):
            sd[k.replace("mlm_head.", "cls.")] = torch.from_numpy(
                rng.standard_normal(v.shape).astype(np.float32))
    sd["bert.pooler.dense.weight"] = torch.zeros(4, 4)
    torch.save(sd, tmp_path / "bert.pth")
    got = load_pretrain_init(str(tmp_path / "bert.pth"))
    want = j_load_init(str(tmp_path / "bert.pth"), agent="hamt")
    assert got["source"] == want["source"] == "bert"
    assert len(got["skipped"]) == len(want["skipped"]) == 1
    new, n, _ = j_transfer(params, want["params"])
    pnew, pn, _ = j_transfer(
        flax_from_state_dict(port.state_dict(), "hamt_pretrain"),
        flax_from_state_dict(got["state_dict"], "hamt_pretrain"))
    assert n == pn > 0
    pl = dict(_leaves(pnew["params"]))
    for p, w in _leaves(new["params"]):
        np.testing.assert_array_equal(pl[p], w, err_msg=p)
    verbatim = load_pretrain_init(str(tmp_path / "bert.pth"),
                                  source="bert-verbatim")
    assert verbatim["source"] == j_load_init(
        str(tmp_path / "bert.pth"), agent="hamt",
        source="bert-verbatim")["source"] == "bert-verbatim"
    assert verbatim["state_dict"].keys() == got["state_dict"].keys()
    with pytest.raises(ValueError, match="DUET"):
        load_pretrain_init(str(tmp_path / "bert.pth"), source="lxmert")
    duet = load_pretrain_init(str(tmp_path / "bert.pth"), agent="duet")
    assert duet["source"] == "bert"
    assert any(k.startswith("bert.lang_encoder.layer.")
               for k in duet["state_dict"])


def test_duet_pretrainer_names_its_item():
    """A `DuetPretrainer` builds (the language side for MLM) and its
    `init_state` draws the JAX package's size-2 probe batches, one a task:
    the next batch is a fresh batcher's after those draws."""
    from vln_imagine_tpu_torch.pretrain.duet_data import (
        DuetTrajectoryBatcher,
    )
    from vln_imagine_tpu_torch.pretrain.trainer import DuetPretrainer

    cfg = _replace(tiny_test_config("duet"), "pretrain",
                   tasks=("mlm", "mrc", "sap"), mix_ratio=(1, 1, 1))
    world, ep = _world_ep(seed=4)
    pt = DuetPretrainer(cfg, world, ep, image_prob_size=P, device="cpu")
    assert pt.model.config.use_lang2visn_attn
    assert hasattr(pt.model.bert.local_encoder.encoder.x_layers[0],
                   "lang_self_att")
    fresh = DuetTrajectoryBatcher(
        world, ep, max_hist_len=cfg.env.max_action_len,
        max_gmap_nodes=cfg.env.max_gmap_nodes,
        angle_feat_size=cfg.model.angle_feat_size, image_prob_size=P,
        vocab_size=cfg.model.vocab_size, seed=cfg.pretrain.seed,
        mlm_prob=cfg.pretrain.mlm_prob)
    assert pt.init_state().step == 0
    for t in cfg.pretrain.tasks:
        fresh.task_batch(t, 2)
    _assert_batches_equal(pt.batcher.task_batch("sap", 3),
                          fresh.task_batch("sap", 3), "after the probes")


def test_save_resume_round_trip(tmp_path):
    _, cfg = _pretrain_cfgs()
    world, ep = _world_ep(seed=2)
    pt = HamtPretrainer(cfg, world, ep, image_prob_size=P, device="cpu")
    state, _ = pt.train(pt.init_state(), 3)
    path = pt.save(state, str(tmp_path))
    other = HamtPretrainer(cfg, world, ep, image_prob_size=P, device="cpu",
                           seed=11)
    back = other.resume(path)
    assert back == state and back.step == 3
    a, b = pt.model.state_dict(), other.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = pt.optimizer.state_dict(), other.optimizer.state_dict()
    assert sa["steps"] == sb["steps"] == 3
    for ga, gb in zip(sa["groups"], sb["groups"]):
        assert ga["count"] == gb["count"]
        for m in ("mu", "nu"):
            assert ga[m].keys() == gb[m].keys()
            assert all(torch.equal(ga[m][i], gb[m][i]) for i in ga[m])
