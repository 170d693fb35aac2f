"""Offline world compiler: connectivity graphs -> dense WorldTables (numpy).

The port's own copy of the JAX package's compiler; the tables it builds are
bit-identical to that package's.

Replaces, at build time, what the reference does at runtime with MatterSim +
networkx + python dict caches:

- nav-graph loading (VLN-HAMT/finetune_src/r2r/data_utils.py:453-478)
- all-pairs shortest paths (env.py:170-186, eval_utils.py FloydGraph)
- candidate generation / closest-view selection (env.py:221-291)
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field

import numpy as np

from vln_imagine_tpu_torch.envx.tables import INF, WorldTables


@dataclass
class ScanGraph:
    """One scan's viewpoint graph in host form."""

    scan_id: str
    node_ids: list[str]
    xyz: np.ndarray                  # [n, 3]
    edges: list[tuple[int, int]]     # undirected, indices into node_ids
    id_to_index: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.id_to_index:
            self.id_to_index = {v: i for i, v in enumerate(self.node_ids)}

    @property
    def num_nodes(self) -> int:
        return len(self.node_ids)


def load_connectivity(connectivity_dir: str, scans: list[str]) -> list[ScanGraph]:
    """Parse Matterport3D `<scan>_connectivity.json` files.

    Format per data_utils.py:453-478: a list of viewpoints with `image_id`,
    4x4 `pose` (position at indices 3, 7, 11), `included` flag, and an
    `unobstructed` adjacency row."""
    graphs = []
    for scan in scans:
        path = os.path.join(connectivity_dir, f"{scan}_connectivity.json")
        with open(path) as f:
            data = json.load(f)
        included = [item["included"] for item in data]
        node_ids, xyz, index = [], [], {}
        for item in data:
            if item["included"]:
                index[item["image_id"]] = len(node_ids)
                node_ids.append(item["image_id"])
                xyz.append([item["pose"][3], item["pose"][7], item["pose"][11]])
        edges = set()
        for i, item in enumerate(data):
            if not item["included"]:
                continue
            for j, conn in enumerate(item["unobstructed"]):
                if conn and included[j]:
                    assert data[j]["unobstructed"][i], "Graph should be undirected"
                    a = index[item["image_id"]]
                    b = index[data[j]["image_id"]]
                    edges.add((min(a, b), max(a, b)))
        graphs.append(ScanGraph(scan, node_ids, np.asarray(xyz, np.float64),
                                sorted(edges)))
    return graphs


def heading_elevation(src: np.ndarray, dst: np.ndarray):
    """MatterSim-convention heading/elevation from src to dst (the simulator's
    x-y axes are transposed: heading 0 = +y, pi/2 = +x;
    VLN-DUET/map_nav_src/models/graph_utils.py:15-32)."""
    d = dst - src
    xy = max(float(np.hypot(d[0], d[1])), 1e-8)
    xyz = max(float(np.linalg.norm(d)), 1e-8)
    heading = math.atan2(d[0], d[1])
    elevation = math.asin(np.clip(d[2] / xyz, -1.0, 1.0))
    del xy
    return heading, elevation


def closest_view(heading: float, elevation: float, views: int = 36) -> int:
    """The discretized view whose centre minimises angular distance to
    (heading, elevation) — reproduces make_candidate's closest-view rule
    (env.py:246-256)."""
    per_row = views // 3
    step = 2.0 * math.pi / per_row
    col = int(round(heading / step)) % per_row
    rows = np.array([-math.radians(30.0), 0.0, math.radians(30.0)])
    row = int(np.argmin(np.abs(rows - elevation)))
    return row * per_row + col


def floyd_warshall(n: int, edges: list[tuple[int, int]], xyz: np.ndarray):
    """Vectorized Floyd-Warshall with next-hop and hop-count reconstruction."""
    dist = np.full((n, n), INF, np.float64)
    nxt = np.full((n, n), -1, np.int64)
    hops = np.full((n, n), 10**6, np.int64)
    np.fill_diagonal(dist, 0.0)
    np.fill_diagonal(hops, 0)
    nxt[np.arange(n), np.arange(n)] = np.arange(n)
    for a, b in edges:
        w = float(np.linalg.norm(xyz[a] - xyz[b]))
        if w < dist[a, b]:
            dist[a, b] = dist[b, a] = w
            nxt[a, b], nxt[b, a] = b, a
            hops[a, b] = hops[b, a] = 1
    for k in range(n):
        alt = dist[:, k:k + 1] + dist[k:k + 1, :]
        better = alt < dist
        dist = np.where(better, alt, dist)
        nxt = np.where(better, nxt[:, k:k + 1], nxt)
        hops = np.where(better, hops[:, k:k + 1] + hops[k:k + 1, :], hops)
    return dist, nxt, hops


def shortest_path_nodes(graph: ScanGraph, src: int, dst: int) -> list[int]:
    """Host-side shortest path (node indices, inclusive of both ends) over a
    ScanGraph — the compile-time stand-in for the reference's networkx
    Dijkstra (env.py:170-186).  Floyd tables are cached ON the graph object
    (not a module dict keyed by id(): a recycled address would silently
    serve a dead graph's tables, and the dict would never free them)."""
    tables = getattr(graph, "_floyd_tables", None)
    if tables is None:
        tables = floyd_warshall(graph.num_nodes, graph.edges, graph.xyz)
        graph._floyd_tables = tables
    _, nxt, _ = tables
    if nxt[src, dst] < 0:
        return [src]
    path = [src]
    node = src
    while node != dst:
        node = int(nxt[node, dst])
        path.append(node)
        assert len(path) <= graph.num_nodes, "broken next-hop table"
    return path


def compile_world(
    graphs: list[ScanGraph],
    max_nodes: int | None = None,
    max_candidates: int | None = None,
    views: int = 36,
    feat: np.ndarray | None = None,
) -> WorldTables:
    """Compile scan graphs into padded dense tables.

    `feat`, if given, is [S, N, views, Df] precomputed view features aligned
    with the padded node indexing."""
    S = len(graphs)
    n_nodes = max(g.num_nodes for g in graphs)
    N = max_nodes or n_nodes
    assert N >= n_nodes, f"max_nodes {N} < largest scan {n_nodes}"
    degree = 0
    for g in graphs:
        if g.edges:
            flat = np.asarray([e for ij in g.edges for e in ij], np.int64)
            degree = max(degree, int(np.bincount(flat, minlength=g.num_nodes).max()))
    K = max_candidates or degree
    assert K >= degree, f"max_candidates {K} < largest degree {degree}"

    node_xyz = np.zeros((S, N, 3), np.float32)
    node_valid = np.zeros((S, N), bool)
    adj = np.zeros((S, N, K), np.int32)
    adj_valid = np.zeros((S, N, K), bool)
    cand_pointid = np.zeros((S, N, K), np.int32)
    cand_heading = np.zeros((S, N, K), np.float32)
    cand_elevation = np.zeros((S, N, K), np.float32)
    dist = np.full((S, N, N), INF, np.float32)
    next_hop = np.zeros((S, N, N), np.int32)
    hops = np.zeros((S, N, N), np.int32)

    for s, g in enumerate(graphs):
        n = g.num_nodes
        node_xyz[s, :n] = g.xyz
        node_valid[s, :n] = True
        neigh: list[list[int]] = [[] for _ in range(n)]
        for a, b in g.edges:
            neigh[a].append(b)
            neigh[b].append(a)
        for i in range(n):
            for slot, j in enumerate(sorted(neigh[i])):
                h, e = heading_elevation(g.xyz[i], g.xyz[j])
                adj[s, i, slot] = j
                adj_valid[s, i, slot] = True
                cand_pointid[s, i, slot] = closest_view(h, e, views)
                cand_heading[s, i, slot] = h
                cand_elevation[s, i, slot] = e
        d, nx, hp = floyd_warshall(n, g.edges, g.xyz)
        dist[s, :n, :n] = d
        next_hop[s, :n, :n] = np.maximum(nx, 0)
        hops[s, :n, :n] = np.minimum(hp, 10**6)

    return WorldTables(
        node_xyz=node_xyz, node_valid=node_valid, adj=adj, adj_valid=adj_valid,
        cand_pointid=cand_pointid, cand_heading=cand_heading,
        cand_elevation=cand_elevation, dist=dist, next_hop=next_hop, hops=hops,
        feat=None if feat is None else np.asarray(feat, np.float32),
    )
