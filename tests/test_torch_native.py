"""The port's ctypes binding of the native C++ runtime
(`vln_imagine_tpu_torch/native.py`, built from native/vln_native.cc into
build/native/) in the cases of tests/test_native.py: the all-pairs world
compiler against the port's python compiler, the simulator against the
port's host simulator, the closest-view rule, the feature bank and its
prefetcher, and the prefetching pre-training batcher against the
synchronous one; then the build rules: the library lies in build/native/,
named by the source's content hash, and native/ gains nothing.  The DUET
prefetching batcher comes with DUET pre-training."""

import numpy as np
import pytest

from vln_imagine_tpu_torch import native
from vln_imagine_tpu_torch.envx.compiler import compile_world, closest_view
from vln_imagine_tpu_torch.envx.hostsim import GraphSimulator
from vln_imagine_tpu_torch.envx.synthetic import random_scan_graph


@pytest.fixture(scope="module")
def graph():
    return random_scan_graph(np.random.default_rng(5), "scanN", 18)


@pytest.fixture(scope="module")
def nworld(graph):
    return native.NativeWorld(graph.xyz, graph.edges)


def test_native_allpairs_matches_python(graph, nworld):
    world = compile_world([graph])
    dist, nxt, hops = nworld.all_pairs()
    n = graph.num_nodes
    np.testing.assert_allclose(dist, np.asarray(world.dist)[0, :n, :n],
                               rtol=1e-6)
    np.testing.assert_array_equal(hops, np.asarray(world.hops)[0, :n, :n])
    # next hops may differ on ties; verify they reconstruct optimal paths
    for a in range(0, n, 3):
        for b in range(0, n, 4):
            cur, total, steps = a, 0.0, 0
            while cur != b:
                nx = int(nxt[cur, b])
                total += dist[cur, nx]
                cur = nx
                steps += 1
                assert steps <= n
            assert abs(total - dist[a, b]) < 1e-6


def test_native_sim_matches_hostsim(graph, nworld):
    host = GraphSimulator({graph.scan_id: graph})
    sim = native.NativeSim(nworld)
    rng = np.random.default_rng(0)
    node = 0
    host.newEpisode(graph.scan_id, graph.node_ids[node], 1.234)
    sim.new_episode(node, 1.234)
    for _ in range(12):
        hs = host.getState()
        ns = sim.get_state()
        assert ns["node"] == hs.location.ix
        assert ns["view_index"] == hs.viewIndex
        assert abs(ns["heading"] - hs.heading) < 1e-9
        assert abs(ns["elevation"] - hs.elevation) < 1e-9
        # same candidate sets with same closest views
        hc = host.candidates()
        nodes, pids, hh, ee = sim.candidates()
        assert len(hc) == len(nodes)
        for nd, pid, h, e in zip(nodes, pids, hh, ee):
            want_pid, want_h, want_e = hc[graph.node_ids[nd]]
            assert pid == want_pid
            assert abs(h - want_h) < 1e-9
            assert abs(e - want_e) < 1e-9
        # random action: rotate or move to a random neighbour
        if rng.random() < 0.5 or not len(nodes):
            turn = int(rng.integers(-2, 3))
            host.makeAction(0, float(turn), 0.0)
            sim.make_action(0, float(turn), 0.0)
        else:
            j = int(rng.integers(0, len(nodes)))
            # host navigable list: current first, then slot order
            host_idx = [loc.ix for loc in host.getState().navigableLocations]
            target = int(nodes[j])
            hidx = host_idx.index(target)
            host.makeAction(hidx, 0.0, 0.0)
            sim.make_action(hidx, 0.0, 0.0)


def test_native_closest_view_rule(nworld, graph):
    sim = native.NativeSim(nworld)
    sim.new_episode(0, 0.0)
    _, pids, hs, es = sim.candidates()
    for pid, h, e in zip(pids, hs, es):
        assert pid == closest_view(h, e)


def test_feature_bank_roundtrip(tmp_path):
    arr = np.arange(24, dtype=np.float32).reshape(4, 6)
    path = str(tmp_path / "bank.f32")
    bank = native.FeatureBank.write(path, arr)
    out = bank.gather(np.array([2, 0, 3]))
    np.testing.assert_array_equal(out, arr[[2, 0, 3]])
    # out-of-range rows come back zeroed
    out2 = bank.gather(np.array([-1, 99]))
    assert (out2 == 0).all()


def test_bank_prefetcher_overlapped_batches(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((64, 8)).astype(np.float32)
    bank = native.FeatureBank.write(str(tmp_path / "bank.f32"), arr)
    pf = native.BankPrefetcher(bank, capacity=16)
    batches = [rng.integers(0, 64, size=n) for n in (16, 7, 12, 1)]
    pf.submit(batches[0])
    for i in range(len(batches)):
        got = pf.wait()
        if i + 1 < len(batches):
            pf.submit(batches[i + 1])  # overlaps with the checks below
        np.testing.assert_array_equal(got, arr[batches[i]])
        assert got.shape == (len(batches[i]), 8)
    # wait() without a submit raises
    import pytest

    with pytest.raises(RuntimeError):
        pf.wait()


def test_prefetch_batcher_matches_synchronous(tmp_path):
    """PrefetchTrajectoryBatcher (native async bank gathers, one batch
    ahead) produces byte-identical batches to the synchronous
    TrajectoryBatcher, and to the JAX package's, and keeps a gather in
    flight between batches (the PrefetchLoader overlap,
    pretrain_src/data/loader.py:90-124)."""
    from vln_imagine_tpu.pretrain.data import TrajectoryBatcher as JBatcher
    from vln_imagine_tpu_torch.config import tiny_test_config
    from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
    from vln_imagine_tpu_torch.pretrain.data import (
        PrefetchTrajectoryBatcher, TrajectoryBatcher)

    cfg = tiny_test_config("hamt")
    world_np, _ = synthetic_world(
        num_scans=2, num_nodes=12, max_candidates=cfg.env.max_candidates,
        views=cfg.env.views, feat_dim=16, seed=5)
    ep = synthetic_episodes(
        world_np, batch=6, max_gt_path_len=cfg.env.max_gt_path_len,
        max_instr_len=cfg.env.max_instr_len,
        max_imaginations=cfg.model.max_imagination_len,
        vocab_size=cfg.model.vocab_size, feat_dim=cfg.model.hidden_size,
        seed=6)
    feat = np.asarray(world_np.feat)
    S, N = feat.shape[:2]
    bank = native.FeatureBank.write(
        str(tmp_path / "bank.f32"), feat.reshape(S * N, -1))

    kw = dict(max_hist_len=cfg.env.max_action_len, angle_feat_size=4,
              image_prob_size=8, vocab_size=cfg.model.vocab_size, seed=9)
    sync = TrajectoryBatcher(world_np, ep, **kw)
    jsync = JBatcher(world_np, ep, **kw)
    pref = PrefetchTrajectoryBatcher(world_np, ep, bank, **kw)
    assert pref.w["feat"] is None  # features only reachable via the bank

    # batch SIZES change mid-stream, like init_state()'s size-2 probes
    # followed by full-size training batches
    plan = [("mlm", 2), ("sap", 2), ("mlm", 3), ("sap", 3), ("mrc", 3),
            ("itm", 5), ("sprel", 3), ("sar", 2), ("mlm", 4)]
    for task, bs in plan:
        a = sync.task_batch(task, bs)
        b = pref.task_batch(task, bs)
        c = jsync.task_batch(task, bs)
        assert pref._pending is not None  # the next gather is in flight
        assert set(a) == set(b) == set(c), (task, set(a) ^ set(b))
        for k in a:
            np.testing.assert_array_equal(
                np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{task}/{k}")
            np.testing.assert_array_equal(
                np.asarray(a[k]), np.asarray(c[k]), err_msg=f"{task}/{k}")


def test_library_builds_into_build_native_only(monkeypatch):
    import os
    import subprocess

    path = native.ensure_built()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path == native.library_path()
    assert path.name.startswith("libvln_native_")
    assert not any(n.startswith("libvln_native_")
                   for n in os.listdir(native.SOURCE.parent))
    # a failing compiler raises, naming the source, and leaves no file

    class Failed:
        returncode, stderr = 1, "boom"

    before = set(os.listdir(native.BUILD_DIR))
    monkeypatch.setattr(native, "library_path",
                        lambda: native.BUILD_DIR / "libvln_native_x.so")
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: Failed())
    with pytest.raises(RuntimeError, match="vln_native.cc"):
        native.ensure_built()
    assert set(os.listdir(native.BUILD_DIR)) == before
