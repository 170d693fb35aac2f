"""Synthetic worlds and episodes.

The reference's datasets (Matterport3D connectivity, R2R annotations, HDF5 ViT
features, imagination features) are external downloads; this module generates
statistically similar stand-ins — random geometric viewpoint graphs with
R2R-scale degree/edge-length/path-length distributions — used by the test
suite and the throughput benchmark.

The port's own copy of the JAX package's generator: the same numpy RNG
calls in the same order, so both packages build bit-identical tables from a
seed, raw imagination images (`imagine_image_size`) included.
"""

from __future__ import annotations

import numpy as np

from vln_imagine_tpu_torch.envx.compiler import ScanGraph, compile_world
from vln_imagine_tpu_torch.envx.tables import EpisodeBatch, WorldTables


def random_scan_graph(rng: np.random.Generator, name: str,
                      num_nodes: int, edge_len: float = 2.25) -> ScanGraph:
    """Random geometric graph: nodes on a jittered grid, edges to nearby
    nodes, guaranteed connected."""
    side = max(2, int(np.ceil(np.sqrt(num_nodes))))
    cells = rng.permutation(side * side)[:num_nodes]
    xy = np.stack([cells // side, cells % side], 1).astype(np.float64)
    xy = (xy + rng.uniform(0.15, 0.85, xy.shape)) * edge_len
    z = rng.uniform(-0.3, 0.3, (num_nodes, 1))
    xyz = np.concatenate([xy, z], 1)

    d2 = ((xyz[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    edges = set()
    # connect each node to its 2-3 nearest neighbours
    for i in range(num_nodes):
        k = int(rng.integers(2, 4))
        for j in np.argsort(d2[i])[:k]:
            edges.add((min(i, int(j)), max(i, int(j))))
    # stitch components together
    parent = list(range(num_nodes))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in edges:
        parent[find(a)] = find(b)
    for i in range(1, num_nodes):
        if find(i) != find(0):
            comp = [j for j in range(num_nodes) if find(j) == find(i)]
            rest = [j for j in range(num_nodes) if find(j) != find(i)]
            best = min(((a, b) for a in comp for b in rest),
                       key=lambda ab: d2[ab[0], ab[1]])
            edges.add((min(best), max(best)))
            parent[find(best[0])] = find(best[1])
    return ScanGraph(name, [f"{name}_vp{i:04d}" for i in range(num_nodes)],
                     xyz, sorted(edges))


def synthetic_world(
    num_scans: int = 2,
    num_nodes: int = 24,
    max_candidates: int | None = None,
    views: int = 36,
    feat_dim: int = 32,
    seed: int = 0,
    with_features: bool = True,
    max_objects: int = 0,
    obj_feat_dim: int | None = None,
) -> tuple[WorldTables, list[ScanGraph]]:
    rng = np.random.default_rng(seed)
    graphs = [random_scan_graph(rng, f"scan{s}", num_nodes)
              for s in range(num_scans)]
    world = compile_world(graphs, max_candidates=max_candidates, views=views)
    S, N = world.node_xyz.shape[:2]
    if with_features:
        feat = rng.standard_normal((S, N, views, feat_dim)).astype(np.float32)
        feat *= 0.5
        world = world.replace(feat=feat)
    if max_objects > 0:
        # REVERIE-style objects: 0..max_objects per node, globally-unique ids
        Do = obj_feat_dim or feat_dim
        obj_feat = (rng.standard_normal((S, N, max_objects, Do)) * 0.5
                    ).astype(np.float32)
        obj_ang = np.stack(
            [rng.uniform(-np.pi, np.pi, (S, N, max_objects)),
             rng.uniform(-0.4, 0.4, (S, N, max_objects))], -1
        ).astype(np.float32)
        n_obj = rng.integers(0, max_objects + 1, (S, N))
        obj_valid = np.arange(max_objects)[None, None, :] < n_obj[:, :, None]
        obj_ids = rng.integers(0, 10_000, (S, N, max_objects)).astype(np.int32)
        obj_valid &= np.asarray(world.node_valid)[:, :, None]
        # normalized bbox positions (x1,y1,x2,y2,area in [0,1])
        x1 = rng.uniform(0, 0.8, (S, N, max_objects))
        y1 = rng.uniform(0, 0.8, (S, N, max_objects))
        w = rng.uniform(0.05, 0.2, (S, N, max_objects))
        h = rng.uniform(0.05, 0.2, (S, N, max_objects))
        obj_pos = np.stack([x1, y1, x1 + w, y1 + h, w * h],
                           -1).astype(np.float32)
        world = world.replace(obj_feat=obj_feat, obj_ang=obj_ang,
                              obj_valid=obj_valid, obj_ids=obj_ids,
                              obj_pos=obj_pos)
    return world, graphs


def synthetic_episodes(
    world: WorldTables,
    batch: int,
    max_gt_path_len: int = 8,
    max_instr_len: int = 16,
    max_imaginations: int = 4,
    vocab_size: int = 128,
    feat_dim: int | None = None,
    seed: int = 0,
    min_hops: int = 2,
    imagine_image_size: int | None = None,
) -> EpisodeBatch:
    """Sample R2R-like episodes: (start, goal) pairs a few hops apart, the
    ground-truth path from the next-hop table, random instruction tokens,
    imagination features, and noun-phrase weight rows; with
    `imagine_image_size` also raw imagination images for e2e_imagination."""
    rng = np.random.default_rng(seed)
    S = world.num_scans
    node_valid = np.asarray(world.node_valid)
    hops = np.asarray(world.hops)
    next_hop = np.asarray(world.next_hop)
    Df = feat_dim or (world.feat.shape[-1] if world.feat is not None else 32)

    scans = rng.integers(0, S, batch)
    starts = np.zeros(batch, np.int64)
    goals = np.zeros(batch, np.int64)
    P = max_gt_path_len
    gt_path = np.zeros((batch, P), np.int64)
    gt_len = np.zeros(batch, np.int64)
    for b in range(batch):
        s = scans[b]
        nodes = np.flatnonzero(node_valid[s])
        while True:
            st = rng.choice(nodes)
            ok = nodes[(hops[s, st, nodes] >= min_hops)
                       & (hops[s, st, nodes] <= P - 1)]
            if len(ok):
                gl = rng.choice(ok)
                break
        starts[b], goals[b] = st, gl
        path = [st]
        cur = st
        while cur != gl:
            cur = next_hop[s, cur, gl]
            path.append(cur)
        gt_len[b] = len(path)
        gt_path[b, :len(path)] = path
        gt_path[b, len(path):] = gl  # pad with the goal

    L, I = max_instr_len, max_imaginations
    txt_len = rng.integers(max(4, L // 2), L + 1, batch)
    txt_ids = rng.integers(4, vocab_size, (batch, L))
    txt_mask = np.arange(L)[None, :] < txt_len[:, None]
    txt_ids = np.where(txt_mask, txt_ids, 0)
    txt_ids[:, 0] = 1  # [CLS]-like

    n_sub = rng.integers(1, I + 1, batch)
    imagine_mask = (np.arange(I)[None, :] < n_sub[:, None]) & \
        (rng.random((batch, I)) < 0.85)
    imagine_feats = (rng.standard_normal((batch, I, Df)) * 0.5).astype(np.float32)
    imagine_feats *= imagine_mask[:, :, None]

    np_weights = np.zeros((batch, I, L), np.float32)
    for b in range(batch):
        # split the instruction into n_sub contiguous sub-instruction segments
        # and pick a short noun-phrase span inside each (data-build-time
        # equivalent of data_utils.py:130-450's spaCy pipeline)
        bounds = np.linspace(1, txt_len[b], n_sub[b] + 1).astype(int)
        for i in range(n_sub[b]):
            if not imagine_mask[b, i]:
                continue
            lo, hi = bounds[i], max(bounds[i] + 1, bounds[i + 1])
            span = rng.integers(1, min(3, hi - lo) + 1)
            st = rng.integers(lo, hi - span + 1)
            np_weights[b, i, st:st + span] = 1.0 / span

    gt_obj_id = None
    if world.obj_feat is not None:
        # target = an object visible at the goal node (fall back to id 0)
        obj_ids_t = np.asarray(world.obj_ids)
        obj_valid_t = np.asarray(world.obj_valid)
        gt_obj_id = np.zeros(batch, np.int32)
        for b in range(batch):
            vis = obj_ids_t[scans[b], goals[b]][obj_valid_t[scans[b],
                                                            goals[b]]]
            gt_obj_id[b] = vis[rng.integers(0, len(vis))] if len(vis) else 0

    imagine_images = None
    if imagine_image_size is not None:
        hw = imagine_image_size
        imagine_images = rng.standard_normal(
            (batch, I, hw, hw, 3)).astype(np.float32)
        imagine_images *= imagine_mask[:, :, None, None, None]

    return EpisodeBatch(
        scan=scans.astype(np.int32),
        start_node=starts.astype(np.int32),
        start_heading=rng.uniform(0, 2 * np.pi, batch).astype(np.float32),
        gt_path=gt_path.astype(np.int32),
        gt_len=gt_len.astype(np.int32),
        txt_ids=txt_ids.astype(np.int32),
        txt_mask=txt_mask,
        imagine_feats=imagine_feats,
        imagine_mask=imagine_mask,
        np_weights=np_weights,
        gt_obj_id=gt_obj_id,
        imagine_images=imagine_images,
    )
