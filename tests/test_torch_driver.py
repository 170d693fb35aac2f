"""The port's FinetuneDriver on the CPU at the tiny config:

- against the JAX package's FinetuneDriver: the JAX init carried into the
  port by the bridge, `validate` on the same split (4-item batches, so the
  last one wraps and bucketing reorders) gives the same metrics, exactly,
  and the same `submit_*.json` and `individual_metrics_*.json`, byte for
  byte (f32; the greedy paths are equal, and the metrics are host numpy
  over them); under DUET's `detailed_output` the same `detail_*.json`
  (trajectories and visited nodes equal, stop probabilities within 1e-5).
  No JAX train step is compiled;
- the port alone: `run` writes its logs and checkpoints; an injected fault
  and an injected NaN loss each roll back, after which the state equals
  `latest_dict` bitwise; bucketed validation equals sequential and
  pipelined equals synchronous, item for item; the augmented-split
  alternation trains; VLN_PROFILE_DIR writes a trace; a model axis above
  1 in `cfg.mesh` builds its mesh over two processes and trains and
  validates as one process does, and the branches of items 4 and 5 run.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_imagine_tpu.config import _replace as j_replace
from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.driver import FinetuneDriver as JFinetuneDriver
from vln_imagine_tpu.driver import SplitData as JSplitData
from vln_imagine_tpu.envx import synthetic_episodes as j_episodes
from vln_imagine_tpu.envx import synthetic_world as j_world
from vln_imagine_tpu_torch.ckpt.convert import state_dict_from_flax
from vln_imagine_tpu_torch.config import _replace, tiny_test_config
from vln_imagine_tpu_torch.driver import FinetuneDriver, SplitData
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world

torch.set_num_threads(2)


def _splits(world_fn, episodes_fn, split_cls, cfg, n_train=6, n_val=6):
    world, graphs = world_fn(
        num_scans=2, num_nodes=16, max_candidates=cfg.env.max_candidates,
        views=cfg.env.views, feat_dim=cfg.model.image_feat_size, seed=0)

    def split(name, n, seed):
        ep = episodes_fn(
            world, batch=n, max_gt_path_len=cfg.env.max_gt_path_len,
            max_instr_len=cfg.env.max_instr_len,
            max_imaginations=cfg.model.max_imagination_len,
            vocab_size=cfg.model.vocab_size, feat_dim=cfg.model.hidden_size,
            seed=seed)
        return split_cls(name, ep, [f"{name}_{i}" for i in range(n)])

    return world, graphs, split("train", n_train, 1), split("val_unseen",
                                                             n_val, 2)


def _driver(log_dir, agent="hamt", **train):
    cfg = _replace(tiny_test_config(agent), "train", **train)
    world, graphs, train_split, val = _splits(synthetic_world,
                                              synthetic_episodes, SplitData,
                                              cfg)
    d = FinetuneDriver(cfg, world, train_split, [val], str(log_dir),
                       graphs=graphs, device="cpu")
    d.setup()
    return d


def _read(path):
    with open(path) as f:
        return f.read()


# ------------------------------------------------------- against the JAX one
@pytest.mark.parametrize("agent, detailed", [
    pytest.param("hamt", False, id="hamt"),
    pytest.param("duet", False, id="duet"),
    pytest.param("duet", True, id="duet-detailed_output"),
])
def test_validate_equals_the_jax_driver(tmp_path, agent, detailed):
    jcfg = j_replace(j_tiny_test_config(agent), "train",
                     detailed_output=detailed)
    jworld, jgraphs, jtrain, jval = _splits(j_world, j_episodes, JSplitData,
                                            jcfg, n_val=7)
    jd = JFinetuneDriver(jcfg, jax.tree.map(jnp.asarray, jworld), jtrain,
                         [jval], str(tmp_path / "jax"), graphs=jgraphs)
    jd.setup()
    want = jd.validate(jval, batch_size=4, write_outputs=True)

    cfg = _replace(tiny_test_config(agent), "train", detailed_output=detailed)
    world, graphs, train, val = _splits(synthetic_world, synthetic_episodes,
                                        SplitData, cfg, n_val=7)
    d = FinetuneDriver(cfg, world, train, [val], str(tmp_path / "port"),
                       graphs=graphs, device="cpu")
    d.setup(init_state_dict=state_dict_from_flax(
        jax.tree.map(np.asarray, jd.state.params), agent))
    got = d.validate(val, batch_size=4, write_outputs=True)
    assert got == want
    assert len(d.eval_step_counts) == 2  # 7 items in batches of 4
    assert _read(tmp_path / "port" / "individual_metrics_val_unseen.json") \
        == _read(tmp_path / "jax" / "individual_metrics_val_unseen.json")
    name = "detail_val_unseen.json" if detailed else "submit_val_unseen.json"
    assert not os.path.exists(tmp_path / "port" / (
        "submit_val_unseen.json" if detailed else "detail_val_unseen.json"))
    port = json.loads(_read(tmp_path / "port" / name))
    assert len(port) == 7
    if not detailed:
        assert _read(tmp_path / "port" / name) == _read(tmp_path / "jax" / name)
        return
    for p, j in zip(port, json.loads(_read(tmp_path / "jax" / name)),
                    strict=True):
        assert p["instr_id"] == j["instr_id"]
        assert p["trajectory"] == j["trajectory"]
        assert p["details"].keys() == j["details"].keys()
        vps = [vp for vp, *_ in p["trajectory"]]
        assert {vps[0], vps[-1]} <= p["details"].keys() <= set(vps)
        for vp, v in j["details"].items():
            assert math.isclose(p["details"][vp]["stop_prob"], v["stop_prob"],
                                rel_tol=1e-5, abs_tol=1e-5), vp


# ----------------------------------------------------------- the port alone
def test_run_writes_logs_and_checkpoints(tmp_path):
    d = _driver(tmp_path)
    d.run(iters=4, log_every=2)
    for name in ("train.txt", "metrics.jsonl", "training_args.json",
                 "ckpts/latest_dict", "ckpts/best_val_unseen",
                 "ckpts/best_val_unseen.json"):
        assert os.path.isfile(tmp_path / name), name
    records = [json.loads(x) for x in _read(tmp_path / "metrics.jsonl")
               .splitlines()]
    assert {r["step"] for r in records} == {2, 4}
    assert all(math.isfinite(r["value"]) for r in records
               if r["tag"].startswith("loss/"))
    assert [t["iters"] for t in d.timings["train"]] == [2, 2]
    assert len(d.eval_step_counts) == 2  # one eval batch per interval
    assert d.trainer.optimizer.steps == 4
    saves = [e["name"] for e in d.ckpt.events if e["op"] == "save"]
    assert saves.count("latest_dict") == 3  # seeded before the first interval


def _assert_equals_latest(d):
    saved = torch.load(os.path.join(d.ckpt.dir, "latest_dict"),
                       weights_only=True)
    now = d.state_dict()
    for part in saved:
        for k, v in saved[part]["state_dict"].items():
            assert torch.equal(now[part]["state_dict"][k], v), (part, k)
        opt, sopt = now[part]["optimizer"], saved[part]["optimizer"]
        assert opt["steps"] == sopt["steps"]
        for g, sg in zip(opt["groups"], sopt["groups"], strict=True):
            assert g["count"] == sg["count"]
            for m in ("mu", "nu"):
                assert g[m].keys() == sg[m].keys()
                assert all(torch.equal(g[m][i], t) for i, t in sg[m].items())


@pytest.mark.parametrize("fault", ["exception", "nan"])
def test_failed_interval_rolls_back_to_latest_dict(tmp_path, monkeypatch,
                                                   fault):
    d = _driver(tmp_path)
    orig = d.train_interval
    moved = {}

    def poisoned(n_iters):
        out = dict(orig(n_iters))  # the interval trains, then fails
        moved["steps"] = d.trainer.optimizer.steps
        if fault == "exception":
            raise RuntimeError("injected fault")
        out["loss"] = float("nan")
        return out

    monkeypatch.setattr(d, "train_interval", poisoned)
    d.run(iters=2, log_every=2, max_failures=2)
    assert moved["steps"] == 2 and d.trainer.optimizer.steps == 0
    log = _read(tmp_path / "train.txt")
    assert ("injected fault" if fault == "exception"
            else "non-finite training metrics") in log
    assert "rolled back to latest_dict" in log
    _assert_equals_latest(d)
    # a fault that persists past max_failures is raised
    monkeypatch.setattr(d, "train_interval", lambda n: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        d.run(iters=6, log_every=2, max_failures=1)


def _per_item(d, batch_size):
    d.validate(d.val_splits[0], batch_size=batch_size, write_outputs=True)
    m = json.loads(_read(os.path.join(d.log_dir,
                                      "individual_metrics_val_unseen.json")))
    return {iid: {k: v[i] for k, v in m.items() if k != "instr_id"}
            for i, iid in enumerate(m["instr_id"])}


@pytest.mark.parametrize("agent", ["hamt", "duet"])
def test_bucketed_validation_equals_sequential(tmp_path, agent):
    """A batch that holds the whole split runs it in order; batches of 4
    run it bucketed by gt path length: every item scores the same."""
    d = _driver(tmp_path, agent)
    n = d.val_splits[0].episodes.scan.shape[0]
    seq = _per_item(d, batch_size=n)
    buck = _per_item(d, batch_size=4)
    assert len(seq) == n == 6 and seq == buck


def test_aug_alternation_trains(tmp_path):
    d = _driver(tmp_path)
    ep = d.train_split.episodes
    aug = SplitData("aug", dataclasses.replace(
        ep, imagine_mask=np.zeros_like(ep.imagine_mask)),
        d.train_split.instr_ids)
    d2 = FinetuneDriver(d.cfg, d.tables, d.train_split, d.val_splits,
                        str(tmp_path / "aug"), aug_split=aug, device="cpu")
    d2.setup()
    logs = d2.train_interval(2)  # iter 0 GT, iter 1 aug
    assert all(math.isfinite(v) for v in logs.values()), logs
    assert d2.aug_sampler.ix == 2 * d2.cfg.train.batch_size


def test_profile_dir_traces_the_first_interval(tmp_path, monkeypatch):
    """The trace holds the program's spans (utils/spans.py) as annotations,
    and no span is kept once the interval ends."""
    from vln_imagine_tpu_torch.utils import spans

    monkeypatch.setenv("VLN_PROFILE_DIR", str(tmp_path / "trace"))
    _driver(tmp_path / "run").run(iters=1, log_every=1)
    traces = [n for n in os.listdir(tmp_path / "trace") if n.endswith(".json")]
    assert traces
    text = (tmp_path / "trace" / traces[0]).read_text()
    for name in ("train.step", "train.rollout", "rollout.step", "env.step",
                 "model.visual", "train.backward", "optim.step"):
        assert f'"name": "{name}"' in text, name
    assert spans.take() == [] and spans.span("x") is spans.span("y")


@pytest.mark.parametrize("part, over, item", [
    # both axes of the mesh are ported (test_torch_dp_driver.py,
    # test_torch_tp_driver.py); here cfg.mesh asks for a model axis
    pytest.param("mesh", {"data_parallelism": 1, "model_parallelism": 2},
                 "7c", id="mesh-over0-7"),
    ("dataset", "r2r_back", 4),
    ("model", {"e2e_imagination": "frozen"}, 5),
])
def test_unported_branches_raise(tmp_path, part, over, item):
    """Items 4, 5 and 7c are ported: the task variants' dataset and
    episodes, `e2e_imagination` with episodes that carry raw images, and a
    model axis of 2 in `cfg.mesh` (two gloo processes, the driver building
    the mesh; parameters of at least 2^10 elements split), once refused
    here, now build a driver that trains and validates, the model axis as
    one process does.  `init_from_pretrain` (item 6) reads the port's
    pre-training snapshots; one that shares no parameter with the
    navigator raises."""
    d = _driver(tmp_path)
    cfg = (d.cfg.replace(dataset=over) if part == "dataset"
           else _replace(d.cfg, part, **over))
    if item == 5:
        def with_images(split, seed):
            ep = split.episodes
            hw = cfg.model.e2e_vit_image_size
            imgs = np.random.default_rng(seed).standard_normal(
                ep.imagine_mask.shape + (hw, hw, 3)).astype(np.float32)
            return SplitData(split.name, dataclasses.replace(
                ep, imagine_images=imgs), split.instr_ids)
        d2 = FinetuneDriver(cfg, d.tables, with_images(d.train_split, 0),
                            [with_images(d.val_splits[0], 1)],
                            str(tmp_path / "e2e"), device="cpu")
        d2.setup()
        assert hasattr(d2.trainer.model, "imagine_vit")
        logs = d2.train_interval(1)
        assert all(math.isfinite(v) for v in logs.values()), logs
        assert 0.0 <= d2.validate(d2.val_splits[0])["sr"] <= 100.0
        return
    if part == "dataset":
        # r2r_back episodes (a midstop per item), under both configs
        ep = dataclasses.replace(d.train_split.episodes,
                                 midstop=d.train_split.episodes.gt_path[:, 1])
        for c, name in ((cfg, "x"), (d.cfg, "y")):
            d2 = FinetuneDriver(c, d.tables, SplitData("train", ep),
                                [SplitData("val_unseen", ep)],
                                str(tmp_path / name), device="cpu")
            d2.setup()
            logs = d2.train_interval(1)
            assert all(math.isfinite(v) for v in logs.values()), logs
            score = d2.validate(d2.val_splits[0])
            assert 0.0 <= score["sr"] <= 100.0
        return
    from _torch_dp import cfg_mesh_driver, spawn

    (tmp_path / "tp").mkdir()
    ranks = spawn("tp_cfg_driver", tmp_path / "tp", world=2, model=2,
                  timeout=240)
    one = cfg_mesh_driver(tmp_path / "one")
    assert one["mesh"] is None and one["split"] == 0
    for r in ranks:
        assert r["mesh"] == (1, 2) and r["split"] > 0
        assert r["score"] == one["score"]
        assert r["logs"].keys() == one["logs"].keys()
        for k, v in one["logs"].items():
            assert r["logs"][k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    torch.save({"unrelated.weight": torch.zeros(2)},
               tmp_path / "model_step_10")
    with pytest.raises(ValueError, match="no parameter subtree"):
        d.init_from_pretrain(str(tmp_path / "model_step_10"))


# ------------------------------------------------------------ task variants
VARIANT_SPLITS = {
    # name -> (agent, dataset, model overrides, objects in the world)
    "reverie_hamt": ("hamt", "reverie",
                     dict(obj_feat_size=32, imagine_enc_pano=False,
                          use_cosine_aux_loss=False, no_lang_ca=True,
                          act_pred_token="ob_hist"), True),
    "reverie_duet": ("duet", "reverie", dict(obj_feat_size=32), True),
    "soon_duet": ("duet", "soon", dict(obj_feat_size=32), True),
    "r2r_back": ("hamt", "r2r_back", {}, False),
    "cvdn": ("hamt", "cvdn", {}, False),
}


def _variant_split(world_fn, episodes_fn, split_cls, cfg, variant, n=7):
    objects = VARIANT_SPLITS[variant][3]
    world, graphs = world_fn(
        num_scans=2, num_nodes=16, max_candidates=cfg.env.max_candidates,
        views=cfg.env.views, feat_dim=cfg.model.image_feat_size, seed=0,
        **(dict(max_objects=3, obj_feat_dim=32) if objects else {}))
    ep = episodes_fn(world, batch=n, max_gt_path_len=cfg.env.max_gt_path_len,
                     max_instr_len=cfg.env.max_instr_len,
                     max_imaginations=cfg.model.max_imagination_len,
                     vocab_size=cfg.model.vocab_size,
                     feat_dim=cfg.model.hidden_size, seed=2)
    end_panos = None
    if variant == "r2r_back":  # the midstop: the gt path's middle node
        ep = ep.replace(midstop=np.asarray(ep.gt_path)[
            np.arange(n), np.asarray(ep.gt_len) // 2])
    if variant == "cvdn":  # the goal and one more goal pano per item
        end_panos = [[int(ep.goal[b]), (int(ep.goal[b]) + 3) % 16]
                     for b in range(n)]
    split = split_cls("val_unseen", ep, [f"val_unseen_{i}" for i in range(n)],
                      end_panos=end_panos)
    return world, graphs, split


@pytest.mark.parametrize("variant", list(VARIANT_SPLITS))
def test_variant_validate_equals_the_jax_driver(tmp_path, variant):
    """Each variant's own metrics (RGS / RGSPL with `predObjId` in the
    submission, the midstop's success, CVDN's goal progress) and its
    output files equal the JAX driver's from the JAX init."""
    agent, dataset, model, _ = VARIANT_SPLITS[variant]
    jcfg = dataclasses.replace(j_replace(j_tiny_test_config(agent), "model",
                                         **model), dataset=dataset)
    jworld, jgraphs, jval = _variant_split(j_world, j_episodes, JSplitData,
                                           jcfg, variant)
    jd = JFinetuneDriver(jcfg, jax.tree.map(jnp.asarray, jworld), jval,
                         [jval], str(tmp_path / "jax"), graphs=jgraphs)
    jd.setup()
    want = jd.validate(jval, batch_size=4, write_outputs=True)

    cfg = dataclasses.replace(_replace(tiny_test_config(agent), "model",
                                       **model), dataset=dataset)
    world, graphs, val = _variant_split(synthetic_world, synthetic_episodes,
                                        SplitData, cfg, variant)
    d = FinetuneDriver(cfg, world, val, [val], str(tmp_path / "port"),
                       graphs=graphs, device="cpu")
    # NavRef's x-layer language branches have no flax params: they keep
    # the port's init
    sd = d.trainer.model.state_dict()
    sd.update(state_dict_from_flax(jax.tree.map(np.asarray, jd.state.params),
                                   agent))
    d.setup(init_state_dict=sd)
    got = d.validate(val, batch_size=4, write_outputs=True)
    assert got == want
    keys = {"reverie_hamt": "rgs", "reverie_duet": "rgspl",
            "soon_duet": "rgs", "r2r_back": "CLS", "cvdn": "gp"}
    assert keys[variant] in got
    for name in ("individual_metrics_val_unseen.json",
                 "submit_val_unseen.json"):
        assert _read(tmp_path / "port" / name) == \
            _read(tmp_path / "jax" / name), name
    sub = json.loads(_read(tmp_path / "port" / "submit_val_unseen.json"))
    assert len(sub) == 7
    if VARIANT_SPLITS[variant][3]:
        assert all(isinstance(p["predObjId"], str) for p in sub)
