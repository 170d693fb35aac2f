"""The task variants' host side in the port against the JAX package, on the
CPU:

- every dataset preset (`rxr_config`, `r4r_config` of both agents,
  `cvdn_config`, `soon_config`, `reverie_config` of both agents): its
  `dataclasses.asdict` equals the JAX preset's;
- `variants.py`: each `eval_item_*` and `eval_batch_variant` on the same
  walks over a synthetic world give the JAX package's scores exactly, and
  the variant registry is the same;
- `envx/hostsim.py` steps like the JAX package's simulator, and as an
  oracle for the compiled environment: `observe_hamt`'s candidate slots
  carry the simulator's neighbours at their closest views, and `step_hamt`
  lands where `makeAction` does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vln_imagine_tpu import config as j_config
from vln_imagine_tpu import variants as j_variants
from vln_imagine_tpu.envx.hostsim import GraphSimulator as JGraphSimulator
from vln_imagine_tpu_torch import config as C
from vln_imagine_tpu_torch import variants as V
from vln_imagine_tpu_torch.envx import env as envx
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.envx.hostsim import GraphSimulator

PRESETS = {
    "rxr": ("rxr_config", ()),
    "r4r_duet": ("r4r_config", ("duet",)),
    "r4r_hamt": ("r4r_config", ("hamt",)),
    "cvdn": ("cvdn_config", ()),
    "soon": ("soon_config", ()),
    "reverie_duet": ("reverie_config", ("duet",)),
    "reverie_hamt": ("reverie_config", ("hamt",)),
}


@pytest.mark.parametrize("name", list(PRESETS))
def test_preset_equals_jax(name):
    fn, args = PRESETS[name]
    got = dataclasses.asdict(getattr(C, fn)(*args))
    assert got == dataclasses.asdict(getattr(j_config, fn)(*args))
    assert got["dataset"] == name.split("_")[0]


@pytest.fixture(scope="module")
def walks():
    """Two scans' distance tables and, per item, a random walk from a gt
    path's start, its gt path, a midstop, goal panos and object ids."""
    world, _ = synthetic_world(num_scans=2, num_nodes=16, max_candidates=7,
                               views=12, feat_dim=8, seed=3)
    ep = synthetic_episodes(world, batch=6, max_gt_path_len=6,
                            max_instr_len=8, max_imaginations=2,
                            vocab_size=32, feat_dim=8, seed=4)
    rng = np.random.default_rng(5)
    items = []
    for b in range(ep.batch):
        s = int(ep.scan[b])
        gt = [int(n) for n in ep.gt_path[b, :ep.gt_len[b]]]
        path = [gt[0]]
        for _ in range(int(rng.integers(1, 6))):
            nbr = world.adj[s, path[-1]][world.adj_valid[s, path[-1]]]
            path.append(int(rng.choice(nbr)))
        if b % 2:
            path = gt  # some walks succeed
        items.append(dict(
            scan=s, path=path, gt=gt,
            midstop=(None if b == 4 else gt[-1] if b % 2
                     else int(rng.choice(path))),
            gt_midstop=gt[-1],
            end_panos=[gt[-1], int(rng.integers(0, 16))],
            goal_vps=[gt[-1], int(rng.integers(0, 16))],
            pred_obj=int(rng.integers(0, 3)), gt_obj=1))
    return world.dist, items


def test_eval_items_equal_jax(walks):
    dist, items = walks
    for it in items:
        d = dist[it["scan"]]
        for name, args in (
                ("eval_item_r2r_back", (it["path"], it["gt"], it["midstop"],
                                        it["gt_midstop"])),
                ("eval_item_ndh", (it["path"], it["end_panos"])),
                ("eval_item_reverie", (it["path"], it["gt"], it["goal_vps"],
                                       it["pred_obj"], it["gt_obj"])),
                ("eval_item_soon", (it["path"], it["gt"], it["goal_vps"],
                                    it["pred_obj"], it["gt_obj"]))):
            got = getattr(V, name)(d, *args)
            assert got == getattr(j_variants, name)(d, *args), name


@pytest.mark.parametrize("variant", list(V.VARIANTS))
def test_eval_batch_variant_equals_jax(walks, variant):
    dist, items = walks
    kw = dict(paths=[it["path"] for it in items],
              gt_paths=[it["gt"] for it in items],
              midstops=[it["midstop"] for it in items],
              gt_midstops=[it["gt_midstop"] for it in items],
              end_panos=[it["end_panos"] for it in items],
              goal_viewpoints=[it["goal_vps"] for it in items],
              pred_objs=[it["pred_obj"] for it in items],
              gt_objs=[it["gt_obj"] for it in items],
              instr_ids=[f"i{k}" for k in range(len(items))])
    scans = np.asarray([it["scan"] for it in items])
    avg, per = V.eval_batch_variant(variant, dist, scans, **kw)
    javg, jper = j_variants.eval_batch_variant(variant, dist, scans, **kw)
    assert avg == javg
    assert dict(per) == dict(jper)
    assert 0.0 < avg["sr"] <= 100.0  # the gt walks succeed


def test_variant_registry_equals_jax():
    assert {k: dataclasses.asdict(v) for k, v in V.VARIANTS.items()} == {
        k: dataclasses.asdict(v) for k, v in j_variants.VARIANTS.items()}


def test_hostsim_is_an_oracle_for_observe_and_step():
    """Walk every item by the simulator and by the compiled environment
    side by side, both taking the simulator's first neighbour."""
    world, graphs = synthetic_world(num_scans=2, num_nodes=14,
                                    max_candidates=7, views=12, feat_dim=8,
                                    seed=9)
    ep = synthetic_episodes(world, batch=4, max_gt_path_len=6,
                            max_instr_len=8, max_imaginations=2,
                            vocab_size=32, feat_dim=8, seed=10)
    # one simulator of each package per item
    sims = [GraphSimulator({g.scan_id: g}, views=12)
            for g in (graphs[s] for s in ep.scan)]
    jsims = [JGraphSimulator({g.scan_id: g}, views=12)
             for g in (graphs[s] for s in ep.scan)]
    w, e = world.to("cpu"), ep.to("cpu")
    st = envx.reset(w, e, 6)
    for b in range(ep.batch):
        g = graphs[int(ep.scan[b])]
        for sim in (sims[b], jsims[b]):
            sim.newEpisode(g.scan_id, g.node_ids[int(ep.start_node[b])],
                           float(ep.start_heading[b]))
    for _ in range(4):
        obs = envx.observe_hamt(w, e, st)
        K = w.max_candidates
        pointid = w.cand_pointid[e.scan.long(), st.node.long()]
        actions = []
        for b in range(ep.batch):
            s = int(ep.scan[b])
            sim, jsim = sims[b], jsims[b]
            state = sim.getState()
            jstate = jsim.getState()
            assert dataclasses.asdict(state) == dataclasses.asdict(jstate)
            assert state.location.ix == int(st.node[b])
            cands = sim.candidates()
            assert cands == jsim.candidates()
            # the valid candidate slots: the simulator's neighbours, each at
            # its closest view
            slots = {int(w.adj[s, st.node[b], k]): int(pointid[b, k])
                     for k in range(K) if bool(obs.cand_valid[b, k])}
            assert slots == {graphs[s].id_to_index[v]: p
                             for v, (p, _, _) in cands.items()}
            # move to the simulator's first navigable neighbour
            target = state.navigableLocations[1].ix
            k = next(k for k in range(K) if bool(obs.cand_valid[b, k])
                     and int(w.adj[s, st.node[b], k]) == target)
            actions.append(k)
            for sm in (sim, jsim):
                sm.makeAction(1, 0, 0)
        st = envx.step_hamt(w, e, st, torch.tensor(actions,
                                                   dtype=torch.int32))
        for b in range(ep.batch):
            assert int(st.node[b]) == sims[b].getState().location.ix
