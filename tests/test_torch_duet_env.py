"""The port's DUET map and environment against the JAX package's, on the CPU:

- every GraphMap function (`envx/gmap.py`) along random walks of three
  items, with inactive lanes, masked candidates and a map capacity small
  enough to overflow: integer and boolean fields equal, floats within 1e-6;
- `observe_duet` and `rel_pos_features` field by field along a walk;
- `dtw_push_multi` / `dtw_ndtw_multi` (the nDTW expert's rows, one per map
  node, extended along random node sequences), and against `dtw_push`;
- `fused_logit_merge` against a literal transcription of the reference's
  per-item loop (tests/test_duet.py:33).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.envx import env as jenv
from vln_imagine_tpu.envx import gmap as JG
from vln_imagine_tpu.envx import synthetic_episodes as j_episodes
from vln_imagine_tpu.envx import synthetic_world as j_world
from vln_imagine_tpu.ops.angles import view_elevation as j_view_elevation
from vln_imagine_tpu.ops.angles import view_heading as j_view_heading
from vln_imagine_tpu_torch.config import tiny_test_config
from vln_imagine_tpu_torch.envx import env as penv
from vln_imagine_tpu_torch.envx import gmap as PG
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.models.duet import fused_logit_merge
from vln_imagine_tpu_torch.ops.angles import view_elevation, view_heading

torch.set_num_threads(2)

FLOAT_TOL = 1e-6
B, HID = 3, 5


def _world_ep(world_fn, episodes_fn, cfg, num_nodes=20, batch=B):
    world, _ = world_fn(num_scans=2, num_nodes=num_nodes,
                        max_candidates=cfg.env.max_candidates,
                        views=cfg.env.views, feat_dim=cfg.model.image_feat_size,
                        seed=1)
    ep = episodes_fn(world, batch=batch, max_gt_path_len=cfg.env.max_gt_path_len,
                     max_instr_len=cfg.env.max_instr_len,
                     max_imaginations=cfg.model.max_imagination_len,
                     vocab_size=cfg.model.vocab_size,
                     feat_dim=cfg.model.hidden_size, seed=2)
    return world, ep


@pytest.fixture(scope="module")
def worlds():
    cfg = tiny_test_config("duet")
    jw, jep = _world_ep(j_world, j_episodes, j_tiny_test_config("duet"))
    pw, pep = _world_ep(synthetic_world, synthetic_episodes, cfg)
    return cfg, jw, jep, pw.to("cpu"), pep.to("cpu")


def _walk(world, ep, steps, seed):
    """Per step: the current node of each item and whether it is active (an
    item stops for good at a random step), moving to a random neighbour."""
    rng = np.random.default_rng(seed)
    scan = np.asarray(ep.scan)
    cur = np.asarray(ep.start_node).copy()
    active = np.ones(B, bool)
    out = []
    for _ in range(steps):
        out.append((cur.copy(), active.copy()))
        active &= rng.random(B) > 0.15
        for b in range(B):
            nb = world.adj[scan[b], cur[b]][world.adj_valid[scan[b], cur[b]]]
            cur[b] = rng.choice(nb)
    return out


def _cmp_state(port, ref, what):
    for f in dataclasses.fields(port):
        a = getattr(port, f.name).detach().numpy()
        b = np.asarray(getattr(ref, f.name))
        assert a.shape == b.shape, f"{what} {f.name}"
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=FLOAT_TOL, atol=FLOAT_TOL,
                                       err_msg=f"{what} {f.name}")
        else:
            assert a.dtype == b.dtype, f"{what} {f.name}"
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {f.name}")


@pytest.mark.parametrize("capacity", [6, 16])
def test_gmap_functions_match_jax_on_random_walks(worlds, capacity):
    """Capacity 6 overflows after the first steps: the overflow lanes go to
    the trash slot in both packages."""
    cfg, jw, jep, pw, pep = worlds
    K = pw.max_candidates
    N = pw.max_nodes
    rng = np.random.default_rng(capacity)
    xyz = np.asarray(jw.node_xyz)
    scan = np.asarray(jep.scan)
    jst = JG.gmap_init(B, capacity, N, HID)
    pst = PG.gmap_init(B, capacity, N, HID)
    _cmp_state(pst, jst, "init")
    overflowed = False
    for t, (cur, active) in enumerate(_walk(jw, jep, 9, seed=capacity)):
        cands = np.asarray(jw.adj)[scan, cur]
        cvalid = np.asarray(jw.adj_valid)[scan, cur] & (rng.random((B, K)) < 0.9)
        weights = np.linalg.norm(xyz[scan[:, None], cands]
                                 - xyz[scan, cur][:, None], axis=-1
                                 ).astype(np.float32)
        avg = rng.standard_normal((B, HID)).astype(np.float32)
        emb = rng.standard_normal((B, K, HID)).astype(np.float32)
        dst = cands[np.arange(B), rng.integers(0, K, B)]
        args = dict(cur=cur.astype(np.int32), active=active,
                    cands=cands.astype(np.int32), cvalid=cvalid,
                    cvalid_act=cvalid & active[:, None], weights=weights,
                    avg=avg, emb=emb, dst=dst.astype(np.int32))

        def ops(M, st, x):
            st = M.add_nodes(st, x("cur")[:, None], x("active")[:, None])
            st = M.add_nodes(st, x("cands"), x("cvalid_act"))
            st = M.add_edges(st, x("cur"), x("cands"), x("weights"),
                             x("cvalid_act"))
            st = M.relax(st, x("cur"), x("active"))
            st = M.set_visited(st, x("cur"), t, x("active"))
            st = M.update_embeds(st, x("cur"), x("avg"), x("cands"), x("emb"),
                                 x("cvalid"), x("active"))
            extra = (M.node_embeds(st), M.pair_dists(st),
                     *M.follow_path(st, x("cur"), x("dst"), 4),
                     *M.follow_path(st, x("dst"), x("cur"), 8))
            return st, extra

        jst, jextra = ops(JG, jst, lambda k: jnp.asarray(args[k]))
        pst, pextra = ops(PG, pst, lambda k: torch.from_numpy(args[k]))
        _cmp_state(pst, jst, f"step {t}")
        for i, (a, b) in enumerate(zip(pextra, jextra)):
            b = np.asarray(b)
            if np.issubdtype(b.dtype, np.floating):
                np.testing.assert_allclose(a.numpy(), b, rtol=FLOAT_TOL,
                                           atol=FLOAT_TOL,
                                           err_msg=f"step {t} extra {i}")
            else:
                np.testing.assert_array_equal(a.numpy(), b,
                                              err_msg=f"step {t} extra {i}")
        overflowed |= bool((pst.count == capacity).any())
    assert overflowed == (capacity == 6)
    assert (pst.visited.sum(dim=1) > 2).any()


def test_observe_duet_and_rel_pos_match_jax(worlds):
    cfg, jw, jep, pw, pep = worlds
    A = cfg.model.angle_feat_size
    jst, pst = jenv.reset(jw, jep, 6), penv.reset(pw, pep, 6)
    rng = np.random.default_rng(3)
    for cur, _ in _walk(jw, jep, 5, seed=4):
        view = rng.integers(0, jw.views, B).astype(np.int32)
        jst = jst.replace(node=jnp.asarray(cur, jnp.int32),
                          view_index=jnp.asarray(view))
        pst = pst.replace(node=torch.from_numpy(cur.astype(np.int32)),
                          view_index=torch.from_numpy(view))
        jobs = jenv.observe_duet(jw, jep, jst, A)
        pobs = penv.observe_duet(pw, pep, pst, A)
        for name in pobs._fields:
            if getattr(pobs, name) is None:  # the object fields: no objects
                # (the JAX observation has no `obj_img`: it pads objects
                # into `img`)
                assert getattr(jobs, name, None) is None, name
                continue
            a, b = getattr(pobs, name).numpy(), np.asarray(getattr(jobs, name))
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_allclose(a, b, rtol=FLOAT_TOL, atol=FLOAT_TOL,
                                       err_msg=name)
        targets = np.asarray(pobs.cand_nodes)
        od = rng.uniform(0, 20, targets.shape).astype(np.float32)
        oh = rng.integers(0, 6, targets.shape).astype(np.float32)
        want = jenv.rel_pos_features(
            jw, jep, jst.node, j_view_heading(jst.view_index, jw.views),
            j_view_elevation(jst.view_index, jw.views), jnp.asarray(targets),
            jnp.asarray(od), jnp.asarray(oh), A)
        got = penv.rel_pos_features(
            pw, pep, pst.node, view_heading(pst.view_index, pw.views),
            view_elevation(pst.view_index, pw.views), torch.from_numpy(targets),
            torch.from_numpy(od), torch.from_numpy(oh), A)
        assert got.shape == want.shape == targets.shape + (A + 3,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FLOAT_TOL, atol=FLOAT_TOL)


def test_fused_logit_merge_matches_reference_loop():
    """The array merge against the reference's per-item loop
    (vilmodel.py:1200-1217), as tests/test_duet.py:33 holds the JAX one."""
    rng = np.random.default_rng(0)
    Bm, G1, T1 = 3, 6, 5
    glob = rng.normal(size=(Bm, G1)).astype(np.float32)
    loc = rng.normal(size=(Bm, T1)).astype(np.float32)
    gmap_valid = np.ones((Bm, G1), bool)
    gmap_valid[:, 5] = [True, False, True]
    gmap_visited = np.zeros((Bm, G1), bool)
    gmap_visited[:, 1] = True
    gmap_visited[0, 2] = True
    vp_nav_valid = np.ones((Bm, T1), bool)
    vp_nav_valid[:, 4] = [False, True, False]
    cand_map = np.full((Bm, T1), -1)
    cand_map[0, 1:4] = [2, 3, 1]
    cand_map[1, 1:5] = [3, 4, 1, 2]
    cand_map[2, 1:4] = [4, 3, 1]
    c2g = np.zeros((Bm, G1, T1), bool)
    for b in range(Bm):
        for j in range(1, T1):
            if cand_map[b, j] >= 0 and vp_nav_valid[b, j]:
                c2g[b, cand_map[b, j], j] = True

    want = glob.copy()
    want[:, 0] += loc[:, 0]
    for b in range(Bm):
        bw, tmp = 0.0, {}
        for j in range(1, T1):
            g = cand_map[b, j]
            if g < 0 or not vp_nav_valid[b, j]:
                continue
            if gmap_visited[b, g] and gmap_valid[b, g]:
                bw += loc[b, j]
            else:
                tmp[g] = loc[b, j]
        for g in range(1, G1):
            if gmap_valid[b, g] and not gmap_visited[b, g]:
                want[b, g] += tmp.get(g, bw)

    t = torch.from_numpy
    got = fused_logit_merge(t(glob), t(loc), t(gmap_visited), t(gmap_valid),
                            t(vp_nav_valid), t(c2g))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_start_edges_of_items_past_the_first_take_item_0s_next_hops():
    """A fault of the JAX package that the port keeps, so that the two
    compute the same function (ROADMAP Queue 3): `gmap_init` builds the
    next-hop and hop tables without a batch dim, so the start node's edges
    of items > 0 are dropped from them until the first `relax` broadcasts
    item 0's.  Here item 1's third candidate, which item 0 lacks, keeps no
    next hop and no hop count at batch 2, and has both alone."""
    cands = np.array([[1, 2, 0], [4, 5, 6]], np.int32)
    cvalid = np.array([[True, True, False], [True, True, True]])
    weights = np.ones((2, 3), np.float32)

    def start(M, x, items):
        st = M.gmap_init(len(items), 8, 10, 2)
        start_node = x(np.array([0, 3], np.int32)[items])
        one = x(np.ones((len(items),), bool))
        st = M.add_nodes(st, start_node[:, None], one[:, None])
        st = M.add_nodes(st, x(cands[items]), x(cvalid[items]))
        st = M.add_edges(st, start_node, x(cands[items]), x(weights[items]),
                         x(cvalid[items]))
        return M.relax(st, start_node, one)

    for M, x in ((JG, jnp.asarray), (PG, torch.from_numpy)):
        both, alone = start(M, x, [0, 1]), start(M, x, [1])
        assert int(np.asarray(both.hops)[1, 0, 3]) == PG.NO_HOPS
        assert int(np.asarray(both.nxt)[1, 0, 3]) == -1
        assert int(np.asarray(alone.hops)[0, 0, 3]) == 1
        assert int(np.asarray(alone.nxt)[0, 0, 3]) == 3
        np.testing.assert_array_equal(np.asarray(both.dist)[1],
                                      np.asarray(alone.dist)[0])


def test_dtw_multi_matches_jax(worlds):
    """Rows [B, M, P+1] pushed through random node sequences, M = 4 walks
    per item with some lanes frozen: rows equal to the JAX package's bit for
    bit (min and add of the same f32 values), nDTW within 1e-6 (the two
    `exp`s may differ in the last bit), and each lane equal to `dtw_push`
    on that lane alone."""
    cfg, jw, jep, pw, pep = worlds
    jw, jep = (jax.tree.map(jnp.asarray, x) for x in (jw, jep))
    M = 4
    rng = np.random.default_rng(3)
    jrows = jnp.broadcast_to(jenv.dtw_init(jw, jep)[:, None, :],
                             (B, M, jep.gt_path.shape[1] + 1))
    prows = penv.dtw_init(pw, pep)[:, None, :].expand(-1, M, -1)
    for t in range(5):
        nodes = rng.integers(0, 20, (B, M)).astype(np.int32)  # 20-node scans
        keep = rng.random((B, M)) < 0.8
        jnew = jenv.dtw_push_multi(jw, jep, jrows, jnp.asarray(nodes))
        pnew = penv.dtw_push_multi(pw, pep, prows, torch.from_numpy(nodes))
        jrows = jnp.where(jnp.asarray(keep)[..., None], jnew, jrows)
        prows = torch.where(torch.from_numpy(keep)[..., None], pnew, prows)
        np.testing.assert_array_equal(prows.numpy(), np.asarray(jrows),
                                      err_msg=f"step {t}")
        np.testing.assert_allclose(
            penv.dtw_ndtw_multi(prows, pep, cfg.env.error_margin).numpy(),
            np.asarray(jenv.dtw_ndtw_multi(jrows, jep, cfg.env.error_margin)),
            rtol=FLOAT_TOL, atol=FLOAT_TOL, err_msg=f"step {t} ndtw")
        for m in range(M):
            one = penv.dtw_push(pw, pep, prows[:, m].contiguous(),
                                torch.from_numpy(nodes[:, m]))
            np.testing.assert_array_equal(one.numpy(),
                                          penv.dtw_push_multi(
                                              pw, pep, prows,
                                              torch.from_numpy(nodes))[:, m]
                                          .numpy())
