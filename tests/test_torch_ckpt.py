"""The port's checkpoints on the CPU:

- twins of tests/test_ckpt_manager.py: round trip, best policy, snapshot
  naming, and a checkpoint of another model refused;
- the optimizer state: a save / load round trip restores every moment,
  count and `steps` bitwise, loads in place, and keeps absent moments
  absent (a parameter that never had a gradient gets none);
- the driver's slot: model, critic, optimizers restored bitwise into a
  fresh driver, with the optimizers still holding the model's parameters;
- the on-ramps: a released-format agent save and a pre-train checkpoint,
  written from the port's own tiny model with the DDP `module.` prefix, go
  through the port's loaders and the JAX package's; the weights agree
  exactly through the bridge, as do the pre-train transfer's counts.
"""

import os

import numpy as np
import pytest
import torch

from vln_imagine_tpu.ckpt import manager as J
from vln_imagine_tpu.ckpt.transfer import (
    init_finetune_from_pretrain as j_init_finetune_from_pretrain,
)
from vln_imagine_tpu_torch.ckpt.convert import (
    critic_flax_from_state_dict,
    flax_from_state_dict,
)
from vln_imagine_tpu_torch.ckpt.manager import CheckpointManager
from vln_imagine_tpu_torch.config import _replace, tiny_test_config
from vln_imagine_tpu_torch.driver import FinetuneDriver, SplitData
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.train.optim import warmup_variant4_optimizer
from vln_imagine_tpu_torch.train.trainer import init_params

torch.set_num_threads(2)


def _state(v):
    return {"vln_bert": {"epoch": int(v),
                         "state_dict": {"a": torch.full((3, 2), float(v)),
                                        "b": torch.arange(4)}}}


# ------------------------------------------------- twins of test_ckpt_manager
def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_latest(_state(7.0))
    back = mgr.load("latest_dict", _state(0.0))
    assert torch.equal(back["vln_bert"]["state_dict"]["a"],
                       torch.full((3, 2), 7.0))
    assert back["vln_bert"]["epoch"] == 7
    assert [e["op"] for e in mgr.events] == ["save", "load"]
    assert mgr.events[0]["bytes"] == os.path.getsize(tmp_path / "latest_dict")


@pytest.mark.parametrize("metric", ["spl_sr", "spl"])
def test_best_policy(tmp_path, metric):
    mgr = CheckpointManager(str(tmp_path), select_metric=metric)
    assert mgr.maybe_save_best(_state(1), "val_unseen", {"spl": 50, "sr": 60})
    # spl+sr falls (HAMT keeps the first); spl alone rises (DUET saves)
    assert mgr.maybe_save_best(_state(2), "val_unseen",
                               {"spl": 51, "sr": 40}) == (metric == "spl")
    assert mgr.maybe_save_best(_state(3), "val_unseen", {"spl": 60, "sr": 60})
    assert mgr.load("best_val_unseen")["vln_bert"]["epoch"] == 3
    with open(tmp_path / "best_val_unseen.json") as f:
        assert f.read() == '{"spl": 60, "sr": 60}'


def test_snapshot_naming_and_best_iteration(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_snapshot(_state(1), 2000, 65.0, 60.0, "val_unseen")
    mgr.save_snapshot(_state(2), 4000, 67.26, 62.02, "val_unseen")
    mgr.save_snapshot(_state(3), 6000, 60.0, 55.0, "val_unseen")
    assert "iter_4000_SR_67.26_SPL_62.02_val_unseen" in mgr.list_snapshots()
    assert mgr.best_iteration("val_unseen") == \
        "iter_4000_SR_67.26_SPL_62.02_val_unseen"


def test_load_refuses_a_differently_configured_model(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_latest(_state(1))
    other = _state(1)
    other["vln_bert"]["state_dict"]["a"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="differently configured"):
        mgr.load("latest_dict", other)
    del other["vln_bert"]["state_dict"]["a"]
    with pytest.raises(ValueError, match="differently configured"):
        mgr.load("latest_dict", other)


# ------------------------------------------------------------ optimizer state
SHAPES = {"contrastive_alignment_model.image_proj.fc1.weight": (5, 3),
          "imagine_embeddings.type_embedding.weight": (1, 4),
          "encoder.layer.0.output.dense.weight": (3, 6),
          "next_action.net.0.bias": (7,)}


def _optimizer(seed=1):
    rng = np.random.default_rng(seed)
    params = {n: torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))) for n, s in SHAPES.items()}
    opt = warmup_variant4_optimizer(list(params.items()), 1e-2, 100, "adamw",
                                    40.0, stage1_iters=2, stage2_iters=4,
                                    weight_decay=0.01)
    return params, opt


def _step(params, opt, rng):
    for p in params.values():
        p.grad = torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                  .astype(np.float32) * 30)
    opt.step()


def test_optimizer_state_round_trip_is_bitwise(tmp_path):
    params, opt = _optimizer()
    rng = np.random.default_rng(2)
    _step(params, opt, rng)  # stage 1: the rest group has no moments
    path = tmp_path / "opt.pt"
    torch.save({"params": {n: p.detach() for n, p in params.items()},
                "opt": opt.state_dict()}, path)
    saved = torch.load(path, weights_only=True)
    params2, opt2 = _optimizer(seed=9)
    with torch.no_grad():
        for n, p in params2.items():
            p.copy_(saved["params"][n])
    opt2.load_state_dict(saved["opt"])
    assert opt2.steps == opt.steps == 1
    for g, g2 in zip(opt.groups, opt2.groups):
        assert g2.count == g.count and set(g2.state) == set(g.state)
        for i, (mu, nu) in g.state.items():
            assert torch.equal(g2.state[i][0], mu)
            assert torch.equal(g2.state[i][1], nu)
    assert not opt2.groups[2].state, "a moment was created for the rest group"
    # the two go on identically, through the unfreeze at step 2
    for _ in range(3):
        seed = int(rng.integers(1 << 30))
        _step(params, opt, np.random.default_rng(seed))
        _step(params2, opt2, np.random.default_rng(seed))
        for n in params:
            assert torch.equal(params[n], params2[n]), n
    assert opt2.groups[2].count == opt.groups[2].count == 2


def test_optimizer_load_is_in_place_and_drops_absent_moments():
    params, stage1 = _optimizer()
    rng = np.random.default_rng(3)
    _step(params, stage1, rng)
    state = stage1.state_dict()
    params2, later = _optimizer()
    for _ in range(4):  # past stage 1: every group has moments
        _step(params2, later, rng)
    assert later.groups[2].state
    held = {i: mu for i, (mu, _) in later.groups[0].state.items()}
    later.load_state_dict(state)
    assert not later.groups[2].state and later.groups[2].count == 0
    for i, (mu, nu) in later.groups[0].state.items():
        assert mu is held[i], "the moment was replaced, not overwritten"
        assert torch.equal(mu, stage1.groups[0].state[i][0])
    assert later.steps == 1
    bad = dict(state, groups=state["groups"][:2])
    with pytest.raises(ValueError, match="groups"):
        later.load_state_dict(bad)


# ------------------------------------------------------------- driver slots
def _driver(agent, log_dir, seed=0):
    cfg = _replace(tiny_test_config(agent), "train", seed=seed)
    world, graphs = synthetic_world(
        num_scans=2, num_nodes=14, max_candidates=cfg.env.max_candidates,
        views=cfg.env.views, feat_dim=cfg.model.image_feat_size, seed=0)

    def split(name, n, s):
        ep = synthetic_episodes(
            world, batch=n, max_gt_path_len=cfg.env.max_gt_path_len,
            max_instr_len=cfg.env.max_instr_len,
            max_imaginations=cfg.model.max_imagination_len,
            vocab_size=cfg.model.vocab_size, feat_dim=cfg.model.hidden_size,
            seed=s)
        return SplitData(name, ep, [f"{name}_{i}" for i in range(n)])

    d = FinetuneDriver(cfg, world, split("train", 6, 1),
                       [split("val_unseen", 3, 2)], str(log_dir),
                       graphs=graphs, device="cpu")
    d.setup()
    return d


def _assert_states_equal(got, want):
    assert got.keys() == want.keys()
    for part in want:
        g, w = got[part], want[part]
        assert g["epoch"] == w["epoch"]
        assert g["state_dict"].keys() == w["state_dict"].keys()
        for k, v in w["state_dict"].items():
            assert torch.equal(g["state_dict"][k], v), (part, k)
        assert g["optimizer"]["steps"] == w["optimizer"]["steps"]
        for gg, wg in zip(g["optimizer"]["groups"], w["optimizer"]["groups"],
                          strict=True):
            assert gg["count"] == wg["count"]
            for m in ("mu", "nu"):
                assert gg[m].keys() == wg[m].keys(), (part, m)
                for i, t in wg[m].items():
                    assert torch.equal(gg[m][i], t), (part, m, i)


@pytest.mark.parametrize("agent", ["hamt", "duet"])
def test_driver_checkpoint_restores_a_fresh_driver_bitwise(tmp_path, agent):
    d1 = _driver(agent, tmp_path / "a")
    d1.run(iters=2, log_every=1)
    saved = torch.load(tmp_path / "a" / "ckpts" / "latest_dict",
                       weights_only=True)
    _assert_states_equal(saved, d1.state_dict())
    assert set(saved) == ({"vln_bert", "critic"} if agent == "hamt"
                          else {"vln_bert"})
    # stage 1 (the tiny config trains 100,000 iterations): no moments for
    # the rest group, neither saved nor restored
    assert not saved["vln_bert"]["optimizer"]["groups"][2]["mu"]

    d2 = _driver(agent, tmp_path / "b", seed=5)
    ptrs = {k: p.data_ptr() for k, p in d2.trainer.model.named_parameters()}
    d2.load_checkpoint(str(tmp_path / "a" / "ckpts" / "latest_dict"))
    _assert_states_equal(d2.state_dict(), saved)
    assert not d2.trainer.optimizer.groups[2].state
    # in place: the optimizers still update the model's own parameters
    params = dict(d2.trainer.model.named_parameters())
    assert {k: p.data_ptr() for k, p in params.items()} == ptrs
    held = {id(p) for g in d2.trainer.optimizer.groups for p in g.params}
    assert held == {id(p) for p in params.values()}


# ---------------------------------------------------------------- on-ramps
def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, np.asarray(v)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _other_weights(d, seed):
    """A state_dict of `d`'s model shapes with weights of another seed."""
    model = type(d.trainer.model)(d.cfg.model)
    init_params(model, torch.Generator().manual_seed(seed))
    return model.state_dict()


@pytest.mark.parametrize("agent", ["hamt", "duet"])
def test_reference_agent_save_loads_as_in_the_jax_package(tmp_path, agent):
    d = _driver(agent, tmp_path / "run")
    sd = _other_weights(d, 11)
    sd["pooler.dense.weight"] = torch.ones(3, 3)  # unused by fine-tuning
    states = {"vln_bert": {"epoch": 4,
                           "state_dict": {"module.vln_bert." + k: v
                                          for k, v in sd.items()},
                           "optimizer": {"state": {}, "param_groups": []}}}
    rng = np.random.default_rng(0)
    H = d.cfg.model.hidden_size
    critic = {"module.state2value.0.weight": torch.from_numpy(
                  rng.standard_normal((512, H)).astype(np.float32)),
              "module.state2value.0.bias": torch.zeros(512),
              "module.state2value.3.weight": torch.from_numpy(
                  rng.standard_normal((1, 512)).astype(np.float32)),
              "module.state2value.3.bias": torch.ones(1)}
    states["critic"] = {"epoch": 4, "state_dict": critic,
                        "optimizer": {"state": {}, "param_groups": []}}
    path = str(tmp_path / "iter_32000_SR_67.26_SPL_62.02_val_unseen")
    torch.save(states, path)

    info = d.init_from_reference(path)
    assert info["epoch"] == 4 and "pooler.dense.weight" in info["skipped"]
    want = J.load_reference_checkpoint(path, agent=agent)
    _assert_trees_equal(flax_from_state_dict(d.trainer.model.state_dict(),
                                             agent), want["params"])
    if agent == "hamt":
        _assert_trees_equal(critic_flax_from_state_dict(
            d.trainer.critic.state_dict()), want["critic_params"])
    # the port's own best_* files read back through the same loader
    d.run(iters=1, log_every=1)
    d2 = _driver(agent, tmp_path / "run2", seed=3)
    d2.init_from_reference(str(tmp_path / "run" / "ckpts" /
                               "best_val_unseen"))
    for k, v in d.trainer.model.state_dict().items():
        assert torch.equal(d2.trainer.model.state_dict()[k], v), k


@pytest.mark.parametrize("agent", ["hamt", "duet"])
def test_bert_ckpt_transfers_as_in_the_jax_package(tmp_path, agent):
    d = _driver(agent, tmp_path / "run")
    before = flax_from_state_dict(d.trainer.model.state_dict(), agent)
    finetune_only = ("imagine_embeddings.", "contrastive_alignment_model.",
                     "next_action.", "global_sap_head.", "local_sap_head.")
    sd = {"module.bert." + k: v for k, v in _other_weights(d, 12).items()
          if not k.startswith(finetune_only)}
    H = d.cfg.model.hidden_size
    sd["module.mlm_head.predictions.transform.dense.weight"] = torch.ones(H, H)
    sd["module.bert.pooler.dense.weight"] = torch.ones(H, H)
    path = str(tmp_path / "model_step_2500.pt")
    torch.save(sd, path)

    info = d.init_from_bert_ckpt(path)
    jloaded = J.load_reference_pretrain(path, agent=agent)
    new, transferred, missing = j_init_finetune_from_pretrain(
        before, jloaded["params"])
    assert info["transferred"] == transferred > 0
    assert info["missing"] == missing and missing
    assert len(info["skipped"]) == len(jloaded["skipped"]) >= 1
    _assert_trees_equal(flax_from_state_dict(d.trainer.model.state_dict(),
                                             agent), new)
    with pytest.raises(ValueError, match="agent-save"):
        torch.save({"vln_bert": {}}, tmp_path / "agent.pt")
        d.init_from_bert_ckpt(str(tmp_path / "agent.pt"))
