"""Detector objects at their own width in the port (SOON's 2,048-d BUTD
features beside 768-d views; here 48 beside 32), against the benchmark's
plain float32 reference (`portbench/reference/duet_obj.py`), on the CPU at
the tiny widths with weights drawn from a seed:

- `DuetModel.panorama_per_step` with objects 48 wide (`obj_linear` /
  `obj_layer_norm`) and 32 wide (the views' projection) against the
  reference's panorama within 1e-5; at 32, bit for bit what the port
  computed before objects kept their own width (one projection over views
  and objects joined);
- a whole greedy eval through `DuetTrainer.make_eval_step()` against the
  reference's replay along its paths: every decision's logits within 1e-4
  (read in the rollout without early exit, slot by map node), the paths
  the reference map's, and each grounded object the reference's best at
  the node the item ends on;
- the object spans (`env.objects`, `model.objects` where the projection is
  the objects' own, `model.ground`, `policy.ground`) and the counter
  `objects.slots` (B x Ko a step) only with objects, one host read a step;
- the reference imports nothing of the program, the cell no JAX.

`soon_butd_config` is `soon_config` with 2,048-d objects and nothing else.
"""

import dataclasses

import numpy as np
import pytest
import torch

from portbench.reference import duet_obj as oref
from portbench.reference.common import Numerics, draw_weights
from portbench.registry import Registry
from portbench.tests.test_portbench_harness import FORBIDDEN, _top_level
from portbench.tests.tiny_soon import OBJ_DIM, SLOTS, make_soon_root
from vln_imagine_tpu_torch.config import soon_butd_config, soon_config
from vln_imagine_tpu_torch.models.duet import DuetModel
from vln_imagine_tpu_torch.train.rollout_duet import rollout_duet
from vln_imagine_tpu_torch.utils import spans

torch.set_num_threads(2)

PANO_TOL = 1e-5
LOGIT_TOL = 1e-4
SEED = 2 ** 31 + 55
OBJECT_SPANS = {"env.objects", "model.objects", "model.ground", "policy.ground"}


def test_soon_butd_config_is_soon_with_wide_objects():
    got, base = soon_butd_config(), soon_config()
    assert got.model.obj_feat_size == 2048 != got.model.image_feat_size
    assert got.replace(model=base.model) == base
    assert got.model.max_imagination_len == 1


def test_the_object_reference_imports_nothing_of_the_program():
    assert not _top_level("portbench.reference.duet_obj") & (
        FORBIDDEN | {"vln_imagine_tpu_torch"})
    assert not _top_level("portbench.agents.duet_obj", "portbench.objects") & FORBIDDEN


def _cell(tmp_path, monkeypatch, obj_dim):
    root = make_soon_root(tmp_path, monkeypatch, obj_dim=obj_dim)
    reg = Registry(root)
    wl = reg.workload("tiny.eval_tiny")
    config, traffic = reg.config(wl["config"]), reg.traffic(wl["traffic"])
    return getattr(reg.agent(config), traffic["cell"])(
        config, traffic, SEED, torch.device("cpu"))


@pytest.mark.parametrize("obj_dim", [OBJ_DIM, 32])
def test_panorama_per_step_against_the_reference(monkeypatch, tmp_path, obj_dim):
    from portbench.tests.tiny_soon import tiny_soon_config

    mcfg = tiny_soon_config(obj_dim).model
    m = dataclasses.asdict(mcfg)
    weights = draw_weights(oref.specs(m), 7, "cpu")
    port = DuetModel(mcfg).eval()
    port.load_state_dict(weights)
    assert hasattr(port.img_embeddings, "obj_linear") == (obj_dim != 32)
    g = torch.Generator().manual_seed(3)
    B, KV, Ko, A = 3, 10, SLOTS, mcfg.angle_feat_size + 3
    view = torch.randn((B, KV, mcfg.image_feat_size), generator=g)
    ok = torch.rand((B, KV + Ko), generator=g) < 0.7
    ok[:, 0] = True
    obj = torch.randn((B, Ko, obj_dim), generator=g) * ok[:, KV:, None]
    loc = torch.randn((B, KV + Ko, A), generator=g) * ok[..., None]
    nav = torch.cat([torch.randint(0, 2, (B, KV), generator=g),
                     2 * ok[:, KV:].long()], 1)
    with torch.no_grad():
        got = port.panorama_per_step(view, loc, nav, ok, obj_img_fts=obj)
        want = oref.ObjDuet(weights, m, Numerics()).panorama_objects(
            view, obj, loc, nav, ok)
        torch.testing.assert_close(got[ok], want[ok], rtol=0, atol=PANO_TOL)
        if obj_dim == 32:  # the objects joined to the views, as before
            before = port.panorama_per_step(torch.cat([view, obj], 1), loc,
                                            nav, ok)
            assert torch.equal(got, before)


@pytest.mark.parametrize("obj_dim", [OBJ_DIM, 32])
def test_greedy_eval_against_the_reference_replay(monkeypatch, tmp_path, obj_dim):
    cell = _cell(tmp_path, monkeypatch, obj_dim)
    ep = cell.batches[0]
    paths, lens, pred = cell.call(0)
    tr = cell.trainer
    with torch.no_grad():
        full = rollout_duet(tr.model, tr.tables, ep, tr.cfg)
    np.testing.assert_array_equal(full.path_nodes.numpy(), paths.numpy())
    np.testing.assert_array_equal(full.pred_obj.numpy(), pred.numpy())
    # the reference along the served paths
    B = ep.batch
    rp = oref.Replay(oref.ObjDuet(cell.w.weights, cell.w.m, Numerics()),
                     cell.w.tables(), cell.w.feat, cell.obj,
                     cell.w.rows(np.arange(B)), cell.first_k(np.arange(B)),
                     cell.w.e)
    assert rp.run(paths.numpy(), lens.numpy()) == 0  # the map's own paths
    assert rp.decisions
    slots = full.stop_nodes.numpy()
    for (b, t), (row, _, _) in rp.decisions.items():
        port_row = full.logits[t, b].numpy()
        for s in np.flatnonzero(np.isfinite(row)):
            j = 0 if s == 0 else 1 + int(np.flatnonzero(
                slots[b] == rp.maps[b].node_ids[s - 1])[0])
            assert abs(port_row[j] - row[s]) <= LOGIT_TOL, (b, t, s)
    for b in range(B):
        end = int(paths[b, lens[b] - 1])
        og, ids = rp.ground[b][end]
        assert int(pred[b]) == int(ids[np.argmax(og)])


WORLDS = {"r2r": 0, "reverie": 32, "soon": OBJ_DIM}


@pytest.mark.parametrize("world", list(WORLDS))
def test_object_spans_and_slots_only_with_objects(monkeypatch, tmp_path, world):
    if WORLDS[world]:
        cell = _cell(tmp_path, monkeypatch, WORLDS[world])
        step, ep = cell.eval_step, cell.batches[0]
    else:
        from test_torch_spans import _trainer

        trainer, ep = _trainer("duet")
        step = trainer.make_eval_step()
    spans.take()
    spans.reset_counts()
    with spans.on():
        step(ep)
    n = spans.counts()
    recs = spans.take()
    by_id = {r.id: r for r in recs}
    parents = {(r.name, by_id[r.parent].name) for r in recs
               if r.name in OBJECT_SPANS}
    assert n["host_reads"] == n["rollout.steps"] == step.steps
    if not WORLDS[world]:
        assert not parents and "objects.slots" not in n
        return
    # the first observation is the prologue's (env.reset)
    want = {("env.objects", "env.reset"), ("env.objects", "env.observe"),
            ("model.ground", "model.navigation"),
            ("policy.ground", "rollout.step")}
    if world == "soon":
        want.add(("model.objects", "model.panorama"))
    assert parents == want
    assert n["objects.slots"] == step.steps * ep.batch * SLOTS
    grounds = [r for r in recs if r.name == "policy.ground"]
    assert len(grounds) == step.steps
