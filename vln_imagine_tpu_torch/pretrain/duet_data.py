"""DUET pre-training data: path-trajectory batches for MLM / MRC / SAP / OG.

The port's own numpy copy of `vln_imagine_tpu/pretrain/duet_data.py`: the
same RNG calls in the same order, so every batch and every draw equals the
JAX package's for the same seed.  Host-side rebuild of R2RTextPathData + task collates
(VLN-DUET/pretrain_src/data/dataset.py:351-508, tasks.py:12-437) over the
compiled world tables.  Trajectories are gt-path prefixes ending at a sampled
step (end_vp_pos_ratio 0.2 ends at the goal, tasks.py:269); steps are
END-ALIGNED in the fixed [B, T, ...] buffers so the local branch can always
read the last step at index -1.
"""

from __future__ import annotations

import math

import numpy as np

from vln_imagine_tpu_torch.envx.tables import EpisodeBatch, WorldTables
from vln_imagine_tpu_torch.ops.angles import all_point_angle_feature
from vln_imagine_tpu_torch.pretrain.data import (
    MASK_TOKEN,
    BankPrefetchMixin,
    draw_batch_indices,
)


class DuetTrajectoryBatcher:
    def __init__(self, world: WorldTables, ep: EpisodeBatch,
                 max_hist_len: int, max_gmap_nodes: int,
                 angle_feat_size: int = 4, image_prob_size: int = 64,
                 vocab_size: int = 1000, seed: int = 0,
                 end_vp_pos_ratio: float = 0.2, mlm_prob: float = 0.15):
        self.w = {k: np.asarray(v) for k, v in
                  dict(adj=world.adj, adj_valid=world.adj_valid,
                       pointid=world.cand_pointid, head=world.cand_heading,
                       elev=world.cand_elevation, feat=world.feat,
                       xyz=world.node_xyz, dist=world.dist,
                       hops=world.hops).items()}
        self.views = world.views
        self.K = world.max_candidates
        self.Df = self.w["feat"].shape[-1]
        self.A = angle_feat_size
        self.T = max_hist_len
        self.G = max_gmap_nodes
        self.P = image_prob_size
        self.vocab = vocab_size
        self.ep = ep
        self.rng = np.random.default_rng(seed)
        # separate stream for batch-index draws so a pipelined subclass that
        # draws indices one batch ahead (PrefetchDuetTrajectoryBatcher)
        # yields byte-identical batches to the synchronous order
        self.idx_rng = np.random.default_rng(seed + 1)
        self.end_ratio = end_vp_pos_ratio
        self.mlm_prob = mlm_prob
        self.angle_table = all_point_angle_feature(angle_feat_size,
                                                   world.views)
        self.paths = [np.asarray(ep.gt_path[b, :ep.gt_len[b]])
                      for b in range(ep.batch)]
        self.scans = np.asarray(ep.scan)
        self.has_obj = world.obj_feat is not None
        self.Ko = world.max_objects if self.has_obj else 0
        if self.has_obj:
            self.w["obj_feat"] = np.asarray(world.obj_feat)
            self.w["obj_ang"] = np.asarray(world.obj_ang)
            self.w["obj_valid"] = np.asarray(world.obj_valid)
            self.w["obj_ids"] = np.asarray(world.obj_ids)
            self.gt_obj = (np.asarray(ep.gt_obj_id)
                           if ep.gt_obj_id is not None else None)
        self.Tp = self.K + self.views + self.Ko

    def _feat(self, scan, node) -> np.ndarray:
        """[V, Df] panorama features of one node; the prefetch subclass
        serves this from an mmap feature bank instead of shadow arrays."""
        return self.w["feat"][scan, node]

    def _pano(self, scan, node, cur_view):
        """DUET pano token bank at one node ([K cands | V views])."""
        K, V, A = self.K, self.views, self.A
        feat = self._feat(scan, node)
        adj_valid = self.w["adj_valid"][scan, node]
        pid = self.w["pointid"][scan, node]
        per = V // 3
        base_h = (cur_view % per) * 2 * math.pi / per
        img = np.zeros((self.Tp, self.Df), np.float32)
        loc = np.zeros((self.Tp, A + 3), np.float32)
        nav = np.zeros((self.Tp,), np.int64)
        valid = np.zeros((self.Tp,), bool)
        for k in range(K):
            if not adj_valid[k]:
                continue
            img[k] = feat[pid[k]]
            dh = self.w["head"][scan, node, k] - base_h
            de = self.w["elev"][scan, node, k]
            loc[k, :A] = np.tile([np.sin(dh), np.cos(dh), np.sin(de),
                                  np.cos(de)], A // 4)
            loc[k, A:] = 1.0
            nav[k] = 1
            valid[k] = True
        used = set(int(p) for p, v in zip(pid, adj_valid) if v)
        img[K:K + V] = feat
        loc[K:K + V, :A] = self.angle_table[cur_view]
        loc[K:K + V, A:] = 1.0
        for v in range(V):
            valid[K + v] = v not in used
        if self.has_obj and self.Ko:
            o_valid = self.w["obj_valid"][scan, node]
            o_feat = self.w["obj_feat"][scan, node]
            Do = min(o_feat.shape[-1], self.Df)
            img[K + V:, :Do] = o_feat[:, :Do] * o_valid[:, None]
            oa = self.w["obj_ang"][scan, node]
            dh = oa[:, 0] - base_h
            loc[K + V:, :A] = np.stack(
                [np.sin(dh), np.cos(dh), np.sin(oa[:, 1]),
                 np.cos(oa[:, 1])], -1).repeat(A // 4, axis=-1
                ).reshape(self.Ko, A) * o_valid[:, None]
            loc[K + V:, A:] = o_valid[:, None].astype(np.float32)
            nav[K + V:] = 2 * o_valid
            valid[K + V:] = o_valid
        return img, loc, nav, valid

    def _rel_pos(self, scan, src, heading, targets):
        """7-d rel pos features (full-graph dist/hops) from src to targets."""
        xyz = self.w["xyz"][scan]
        out = np.zeros((len(targets), self.A + 3), np.float32)
        for i, t in enumerate(targets):
            d = xyz[t] - xyz[src]
            xyz_dist = max(float(np.linalg.norm(d)), 1e-8)
            h = math.atan2(d[0], d[1]) - heading
            e = math.asin(np.clip(d[2] / xyz_dist, -1, 1))
            out[i, :self.A] = np.tile([np.sin(h), np.cos(h), np.sin(e),
                                       np.cos(e)], self.A // 4)
            out[i, self.A:] = (xyz_dist / 30.0,
                               self.w["dist"][scan, src, t] / 30.0,
                               self.w["hops"][scan, src, t] / 10.0)
        return out

    def base_batch(self, idxs: np.ndarray):
        B = len(idxs)
        T, Tp, G, A, K, V = self.T, self.Tp, self.G, self.A, self.K, self.views
        per = V // 3
        out = {
            "txt_ids": np.asarray(self.ep.txt_ids)[idxs],
            "txt_masks": np.asarray(self.ep.txt_mask)[idxs],
            "traj_img": np.zeros((B, T, Tp, self.Df), np.float32),
            "traj_loc": np.zeros((B, T, Tp, A + 3), np.float32),
            "traj_nav": np.zeros((B, T, Tp), np.int64),
            "traj_valid": np.zeros((B, T, Tp), bool),
            "agg": np.zeros((B, G, T * Tp), np.float32),
            "gmap_step_ids": np.zeros((B, G + 1), np.int64),
            "gmap_pos_fts": np.zeros((B, G + 1, A + 3), np.float32),
            "gmap_valid": np.zeros((B, G + 1), bool),
            "gmap_visited": np.zeros((B, G + 1), bool),
            "gmap_pair_dists": np.zeros((B, G + 1, G + 1), np.float32),
            "vp_pos_fts": np.zeros((B, Tp + 1, 14), np.float32),
            "vp_valid": np.zeros((B, Tp + 1), bool),
            "vp_nav_valid": np.zeros((B, Tp + 1), bool),
            "cand_to_gmap": np.zeros((B, G + 1, Tp + 1), bool),
            "global_act_labels": np.zeros((B,), np.int64),
            "local_act_labels": np.zeros((B,), np.int64),
            "vp_view_mrc_masks": np.zeros((B, Tp), bool),
            "vp_view_probs": np.zeros((B, Tp, self.P), np.float32),
            "vp_obj_valid": np.zeros((B, Tp + 1), bool),
            "obj_labels": np.full((B,), -100, np.int64),
        }
        out["gmap_valid"][:, 0] = True

        for i, b in enumerate(idxs):
            scan = self.scans[b]
            path = self.paths[b]
            L = len(path)
            # sample the end position (tasks.py:269: 20% at the goal)
            if self.rng.random() < self.end_ratio:
                t_end = L - 1
            else:
                t_end = int(self.rng.integers(0, L))
            n_steps = min(t_end + 1, T)
            offset = T - n_steps  # end-aligned
            cur_view = V // 3
            visited_order: list[int] = []
            visit_tokens: dict[int, list[int]] = {}
            visit_step: dict[int, int] = {}
            cand_order: list[int] = []
            cand_occurrences: dict[int, list[int]] = {}

            for s in range(n_steps):
                node = int(path[t_end + 1 - n_steps + s])
                img, loc, nav, valid = self._pano(scan, node, cur_view)
                ti = offset + s
                out["traj_img"][i, ti] = img
                out["traj_loc"][i, ti] = loc
                out["traj_nav"][i, ti] = nav
                out["traj_valid"][i, ti] = valid
                if node not in visited_order:
                    visited_order.append(node)
                # rewrite semantics: only the latest visit's tokens stay
                visit_tokens[node] = list(np.flatnonzero(valid) + ti * Tp)
                visit_step[node] = t_end + 1 - n_steps + s
                adj = self.w["adj"][scan, node]
                adj_valid = self.w["adj_valid"][scan, node]
                for k in range(K):
                    if not adj_valid[k]:
                        continue
                    c = int(adj[k])
                    if c not in cand_order:
                        cand_order.append(c)
                    cand_occurrences.setdefault(c, []).append(ti * Tp + k)
                if s < n_steps - 1:
                    nxt = path[t_end + 1 - n_steps + s + 1]
                    slot = int(np.flatnonzero((adj == nxt) & adj_valid)[0])
                    cur_view = int(self.w["pointid"][scan, node, slot])

            visited = set(visited_order)
            # keep the SAP target in range even when the buffer truncates
            nxt_node = int(path[t_end + 1]) if t_end < L - 1 else None
            unvisited = [c for c in cand_order if c not in visited]
            if nxt_node is not None and nxt_node in unvisited:
                unvisited.remove(nxt_node)
                unvisited.insert(0, nxt_node)
            gmap_nodes = (visited_order + unvisited)[:G]
            for g, nd in enumerate(gmap_nodes):
                if nd in visited:
                    tok = visit_tokens[nd]
                    out["agg"][i, g, tok] = 1.0 / len(tok)
                    out["gmap_step_ids"][i, g + 1] = 1 + visit_step[nd]
                    out["gmap_visited"][i, g + 1] = True
                else:
                    occ = cand_occurrences[nd]
                    out["agg"][i, g, occ] = 1.0 / len(occ)
                out["gmap_valid"][i, g + 1] = True

            last = int(path[t_end])
            heading = (cur_view % per) * 2 * math.pi / per
            pos = self._rel_pos(scan, last, heading, gmap_nodes)
            out["gmap_pos_fts"][i, 1:len(gmap_nodes) + 1] = pos
            for gi, a in enumerate(gmap_nodes):
                for gj, bb in enumerate(gmap_nodes):
                    out["gmap_pair_dists"][i, gi + 1, gj + 1] = \
                        self.w["dist"][scan, a, bb]

            # local vp branch (stop + last-step pano)
            out["vp_valid"][i, 0] = True
            out["vp_valid"][i, 1:] = out["traj_valid"][i, -1]
            out["vp_nav_valid"][i, 0] = True
            out["vp_nav_valid"][i, 1:] = out["traj_nav"][i, -1] == 1
            start = int(path[max(0, t_end + 1 - n_steps)])
            start_pos = self._rel_pos(scan, last, heading, [start])[0][:7]
            out["vp_pos_fts"][i, :, :7] = start_pos
            adj = self.w["adj"][scan, last]
            adj_valid = self.w["adj_valid"][scan, last]
            cand_pos = self._rel_pos(
                scan, last, heading,
                [int(a) if v else last for a, v in zip(adj, adj_valid)])
            out["vp_pos_fts"][i, 1:K + 1, 7:] = cand_pos[:, :7] * \
                adj_valid[:, None]
            for k in range(K):
                if adj_valid[k] and int(adj[k]) in gmap_nodes:
                    g = gmap_nodes.index(int(adj[k]))
                    out["cand_to_gmap"][i, g + 1, k + 1] = True

            # SAP labels
            if t_end == L - 1:
                out["global_act_labels"][i] = 0
                out["local_act_labels"][i] = 0
            else:
                nxt = int(path[t_end + 1])
                out["global_act_labels"][i] = gmap_nodes.index(nxt) + 1
                slot = int(np.flatnonzero((adj == nxt) & adj_valid)[0])
                out["local_act_labels"][i] = slot + 1

            # OG labels (REVERIE/SOON pretrain, tasks.py:364-437): the gt
            # object's token index at the last node, stop-offset included
            if self.has_obj and self.Ko and self.gt_obj is not None:
                o_valid = self.w["obj_valid"][scan, last]
                o_ids = self.w["obj_ids"][scan, last]
                out["vp_obj_valid"][i, 1 + K + V:] = o_valid
                hits = np.flatnonzero(o_valid
                                      & (o_ids == self.gt_obj[b]))
                if len(hits):
                    out["obj_labels"][i] = 1 + K + V + hits[0]

            # MRC: mask last-step view tokens (tasks.py:159-228)
            lv = out["traj_valid"][i, -1]
            m = (self.rng.random(Tp) < 0.15) & lv
            if not m.any() and lv.any():
                m[self.rng.choice(np.flatnonzero(lv))] = True
            out["vp_view_mrc_masks"][i] = m
            out["vp_view_probs"][i] = self.rng.dirichlet(
                np.ones(self.P), size=Tp).astype(np.float32)
            out["traj_img"][i, -1][m] = 0.0

        return out

    def mlm_batch(self, idxs, mlm_prob=None):
        mlm_prob = self.mlm_prob if mlm_prob is None else mlm_prob
        batch = self.base_batch(idxs)
        ids = batch["txt_ids"].copy()
        labels = np.full_like(ids, -1)
        mask = (self.rng.random(ids.shape) < mlm_prob) & batch["txt_masks"]
        mask[:, 0] = False
        for i in range(len(ids)):
            if not mask[i].any():
                cands = np.flatnonzero(batch["txt_masks"][i])[1:]
                mask[i, self.rng.choice(cands)] = True
        r = self.rng.random(ids.shape)
        labels[mask] = ids[mask]
        ids[mask & (r < 0.8)] = MASK_TOKEN
        rand = mask & (r >= 0.8) & (r < 0.9)
        ids[rand] = self.rng.integers(4, self.vocab, int(rand.sum()))
        batch["txt_ids"] = ids
        batch["txt_labels"] = labels
        return batch

    def task_batch(self, task: str, batch_size: int, idxs=None):
        if idxs is None:
            idxs = draw_batch_indices(self.idx_rng, self.ep.batch,
                                      batch_size)
        if task == "mlm":
            return self.mlm_batch(idxs)
        if task in ("mrc", "sap", "og"):
            return self.base_batch(idxs)
        raise ValueError(task)


class PrefetchDuetTrajectoryBatcher(BankPrefetchMixin, DuetTrajectoryBatcher):
    """The DUET batcher over the asynchronous native feature bank (the
    reference's PrefetchLoader wraps the DUET pre-training loaders too,
    VLN-DUET/pretrain_src/data/loader.py:90-124)."""

    def __init__(self, world: WorldTables, ep: EpisodeBatch, bank,
                 max_batch_rows: int = 1024, **kwargs):
        super().__init__(world, ep, **kwargs)
        self._bank_init(world, bank, max_batch_rows)
