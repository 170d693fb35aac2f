"""The reference's own navigation tables, worked out again from the graphs.

For each node: its neighbours in ascending index order (the candidate
slots), the heading and elevation to each in the simulator's convention
(heading 0 = +y, pi/2 = +x), and the discretized view closest to that
direction.  Plain numpy over `worldgen`'s graph tuples; nothing of the
program's compiled world is read.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import angle_feature, view_elevation, view_heading


def closest_view(heading: float, elevation: float, views: int) -> int:
    per_row = views // 3
    col = int(round(heading / (2.0 * math.pi / per_row))) % per_row
    rows = np.array([-math.radians(30.0), 0.0, math.radians(30.0)])
    return int(np.argmin(np.abs(rows - elevation))) * per_row + col


class Tables:
    """adj, adj_valid, pointid, heading, elevation as [S, N, K] tensors,
    node xyz [S, N, 3], on `device`."""

    def __init__(self, graphs, max_candidates: int, views: int, device):
        S = len(graphs)
        N = max(len(xyz) for _, xyz, _ in graphs)
        K = max_candidates
        adj = np.zeros((S, N, K), np.int64)
        valid = np.zeros((S, N, K), bool)
        pointid = np.zeros((S, N, K), np.int64)
        heading = np.zeros((S, N, K), np.float32)
        elevation = np.zeros((S, N, K), np.float32)
        node_xyz = np.zeros((S, N, 3), np.float32)
        for s, (_, xyz, edges) in enumerate(graphs):
            node_xyz[s, :len(xyz)] = xyz
            neigh = [[] for _ in range(len(xyz))]
            for a, b in edges:
                neigh[a].append(b)
                neigh[b].append(a)
            for i, ns in enumerate(neigh):
                if len(ns) > K:
                    raise ValueError(f"node degree {len(ns)} > {K} candidates")
                for slot, j in enumerate(sorted(ns)):
                    d = xyz[j] - xyz[i]
                    h = math.atan2(d[0], d[1])
                    e = math.asin(np.clip(d[2] / max(float(np.linalg.norm(d)),
                                                     1e-8), -1.0, 1.0))
                    adj[s, i, slot] = j
                    valid[s, i, slot] = True
                    pointid[s, i, slot] = closest_view(h, e, views)
                    heading[s, i, slot] = h
                    elevation[s, i, slot] = e
        self.views, self.K = views, K
        self.np_adj, self.np_valid = adj, valid
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.adj, self.valid, self.pointid = t(adj), t(valid), t(pointid)
        self.heading, self.elevation = t(heading), t(elevation)
        self.node_xyz = t(node_xyz)

    def see(self, feat, scan, node, view):
        """What an agent sees at `node` facing `view`: the candidates'
        features and angles (zero where absent), the node's view features,
        their angles from the current heading, the candidates' validity,
        and which views a candidate claims."""
        B, V = scan.shape[0], self.views
        node_feat = feat[scan, node]                              # [B, V, Df]
        valid = self.valid[scan, node]
        pointid = self.pointid[scan, node]
        base = view_heading(view, V)[:, None]
        cand_img = torch.gather(node_feat, 1, pointid[:, :, None].expand(
            -1, -1, node_feat.shape[-1])) * valid[:, :, None]
        cand_ang = angle_feature(self.heading[scan, node] - base,
                                 self.elevation[scan, node]) * valid[:, :, None]
        v = torch.arange(V, device=scan.device)
        pano_ang = angle_feature(view_heading(v, V)[None] - base,
                                 view_elevation(v, V)[None].expand(B, V))
        claimed = (F.one_hot(pointid, V).bool() & valid[:, :, None]).any(1)
        return cand_img, cand_ang, node_feat, pano_ang, valid, claimed
