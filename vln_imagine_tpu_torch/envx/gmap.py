"""Tensor topological GraphMap of the DUET agent, batched.

The port of `vln_imagine_tpu/envx/gmap.py`.  The reference keeps one python
GraphMap per batch item: dict node positions, an incremental string-keyed
Floyd-Warshall and running-mean node embeddings
(VLN-DUET/map_nav_src/models/graph_utils.py:43-148).  Here the maps of the
whole batch are fixed-capacity tensors:

- slots [0..G): insertion-ordered node buffer per item; `slot_of[b, n]` maps
  a scan node id to its slot (-1 when absent)
- `dist/nxt/hops` [B, G+1, G+1] (see `_item` for nxt/hops): observed-subgraph shortest paths kept by
  the same incremental relaxation as FloydGraph.update (relax only through
  nodes as they are visited), with next-hop chasing in place of the
  recursive midpoint `path()` (graph_utils.py:76-92)
- a trash slot (index G) and a trash column of `slot_of` absorb the writes
  of masked lanes, so every scatter keeps its shape

A scatter may write one index from several lanes only where every one of
them writes the value already there (masked lanes rewrite the trash), or
reduces by min or by addition: so the order in which duplicate writes land,
which neither CUDA nor the CPU fixes, never changes a result.

All functions return a new state; none writes into its input.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vln_imagine_tpu_torch.envx.tables import INF, _Arrays

NO_HOPS = 10 ** 6  # hop count of a pair with no observed path


@dataclass(frozen=True)
class GmapState(_Arrays):
    node_ids: torch.Tensor     # [B, G+1] i32 (slot G = trash)
    slot_of: torch.Tensor      # [B, N+1] i32, -1 when absent (column N = trash)
    count: torch.Tensor        # [B] i32
    visited: torch.Tensor      # [B, G+1] bool
    step_ids: torch.Tensor     # [B, G+1] i32
    emb_sum: torch.Tensor      # [B, G+1, H] f32
    emb_cnt: torch.Tensor      # [B, G+1] f32
    dist: torch.Tensor         # [B, G+1, G+1] f32
    nxt: torch.Tensor          # [B|1, G+1, G+1] i32 (slot index of next hop)
    hops: torch.Tensor         # [B|1, G+1, G+1] i32
    stop_scores: torch.Tensor  # [B, G+1] f32 (per-node stop prob)

    @property
    def capacity(self) -> int:
        return self.node_ids.shape[1] - 1

    @property
    def trash(self) -> int:
        return self.node_ids.shape[1] - 1

    def valid(self) -> torch.Tensor:
        """[B, G+1] slot validity."""
        G1 = self.node_ids.shape[1]
        return (torch.arange(G1, device=self.count.device)[None, :]
                < self.count[:, None])


def gmap_init(batch: int, capacity: int, max_nodes: int, hidden: int,
              device=None) -> GmapState:
    G1 = capacity + 1
    eye = torch.eye(G1, dtype=torch.bool, device=device)[None]
    ar = torch.arange(G1, dtype=torch.int32, device=device)
    return GmapState(
        node_ids=torch.zeros((batch, G1), dtype=torch.int32, device=device),
        # one trash column, so that masked lanes never collide with a genuine
        # write to node id 0
        slot_of=torch.full((batch, max_nodes + 1), -1, dtype=torch.int32,
                           device=device),
        count=torch.zeros((batch,), dtype=torch.int32, device=device),
        visited=torch.zeros((batch, G1), dtype=torch.bool, device=device),
        step_ids=torch.zeros((batch, G1), dtype=torch.int32, device=device),
        emb_sum=torch.zeros((batch, G1, hidden), device=device),
        emb_cnt=torch.zeros((batch, G1), device=device),
        dist=torch.where(eye, 0.0, INF).expand(batch, G1, G1).contiguous(),
        # without a batch dim until the first `relax`, as in the JAX package
        # (see `_item`)
        nxt=torch.where(eye, ar[None, :, None], -1).to(torch.int32),
        hops=torch.where(eye, 0, NO_HOPS).to(torch.int32),
        stop_scores=torch.full((batch, G1), -torch.inf, device=device),
    )


def _b(batch: int, device) -> torch.Tensor:
    return torch.arange(batch, device=device)


def _item(table: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batch indices into `nxt` or `hops`, clamped as JAX clamps a gather.

    The JAX package's `gmap_init` builds these two tables with a batch dim
    of 1; they take the batch's size at the first `relax`, which broadcasts
    them.  Until then JAX reads item 0's table for every item and drops the
    writes of items > 0 (out-of-range scatter indices are dropped): so at a
    batch above 1 the start node's edges of items > 0 get item 0's next hops
    and hop counts.  The port keeps this, so that both packages compute the
    same function (ROADMAP Queue 3)."""
    return b.clamp(max=table.shape[0] - 1)


def _slot(st: GmapState, nodes: torch.Tensor) -> torch.Tensor:
    """slot_of[b, nodes[b, ...]] for nodes [B, M]."""
    return st.slot_of.gather(1, nodes.long())


def add_nodes(st: GmapState, nodes: torch.Tensor, valid: torch.Tensor
              ) -> GmapState:
    """Insert nodes[b, m] (mutually distinct per item) that are absent.
    Masked or existing entries write idempotently / to the trash slot."""
    B = nodes.shape[0]
    existing = _slot(st, nodes)                                    # [B, M]
    is_new = valid & (existing < 0)
    new_slot = st.count[:, None] + torch.cumsum(is_new, dim=1) - 1
    overflow = new_slot >= st.capacity
    target = torch.where(is_new & ~overflow, new_slot,
                         torch.where(valid & (existing >= 0), existing,
                                     st.trash)).long()
    b = _b(B, nodes.device)[:, None].expand_as(target)
    node_ids = st.node_ids.index_put(
        (b, target), torch.where(target == st.trash, st.node_ids[:, -1:],
                                 nodes).to(torch.int32))
    # masked lanes write the trash column, not node id 0
    n_trash = st.slot_of.shape[1] - 1
    ok = valid & ~overflow
    slot_of = st.slot_of.index_put(
        (b, torch.where(ok, nodes.long(), n_trash)),
        torch.where(ok, target, st.slot_of[:, -1:]).to(torch.int32))
    count = torch.clamp(st.count + torch.sum(is_new & ~overflow, dim=1),
                        max=st.capacity).to(torch.int32)
    return st.replace(node_ids=node_ids, slot_of=slot_of, count=count)


def add_edges(st: GmapState, src_node: torch.Tensor, dst_nodes: torch.Tensor,
              weights: torch.Tensor, valid: torch.Tensor) -> GmapState:
    """Undirected edges src->dst_k with euclidean weights
    (GraphMap.update_graph, graph_utils.py:106-112)."""
    B, K = dst_nodes.shape
    s = _slot(st, src_node[:, None])                               # [B, 1]
    d = _slot(st, dst_nodes)                                       # [B, K]
    ok = valid & (s >= 0) & (d >= 0)
    s_idx = torch.where(ok, s.expand(B, K), st.trash).long()
    d_idx = torch.where(ok, d, st.trash).long()
    b = _b(B, dst_nodes.device)[:, None].expand(B, K)

    cur = st.dist[b, s_idx, d_idx]
    better = ok & (weights < cur)
    s_w = torch.where(better, s_idx, st.trash)
    d_w = torch.where(better, d_idx, st.trash)
    G1 = st.dist.shape[1]
    w = weights.to(st.dist.dtype)
    dist = st.dist.flatten(1)
    for i, j in ((s_w, d_w), (d_w, s_w)):  # .at[].min, both directions
        dist = dist.scatter_reduce(1, (i * G1 + j), w, "amin")
    dist = dist.view_as(st.dist)
    # the writes of items the tables do not hold yet are dropped (`_item`)
    n = st.nxt.shape[0]
    b, s_w, d_w = b[:n], s_w[:n], d_w[:n]
    nxt = st.nxt.index_put((b, s_w, d_w), d_w.to(torch.int32))
    nxt = nxt.index_put((b, d_w, s_w), s_w.to(torch.int32))
    one = torch.ones((), dtype=torch.int32, device=st.hops.device)
    hops = st.hops.index_put((b, s_w, d_w), one)
    hops = hops.index_put((b, d_w, s_w), one)
    return st.replace(dist=dist, nxt=nxt, hops=hops)


def relax(st: GmapState, k_node: torch.Tensor, active: torch.Tensor
          ) -> GmapState:
    """One Floyd relaxation through the (just visited) node k
    (FloydGraph.update, graph_utils.py:62-71)."""
    B = k_node.shape[0]
    b = _b(B, k_node.device)
    k = _slot(st, k_node[:, None])[:, 0]
    k = torch.where(active & (k >= 0), k, st.trash).long()
    dk = st.dist[b, :, k]                     # [B, G+1] distances x->k
    hk = st.hops[_item(st.hops, b), :, k]
    alt = dk[:, :, None] + dk[:, None, :]
    better = (alt < st.dist) & active[:, None, None]
    # never the trash row or column
    G1 = st.dist.shape[1]
    keep = torch.arange(G1, device=k.device) == st.trash
    better = better & ~keep[None, :, None] & ~keep[None, None, :]
    dist = torch.where(better, alt, st.dist)
    nxt = torch.where(better, st.nxt[_item(st.nxt, b), :, k][:, :, None],
                      st.nxt)
    hops = torch.where(better, hk[:, :, None] + hk[:, None, :], st.hops)
    return st.replace(dist=dist, nxt=nxt, hops=hops)


def _row_slot(st: GmapState, node: torch.Tensor,
              active: torch.Tensor) -> torch.Tensor:
    """The slot of node[b] where active and present, else the trash."""
    s = _slot(st, node[:, None])[:, 0]
    return torch.where(active & (s >= 0), s, st.trash).long()


def set_visited(st: GmapState, node: torch.Tensor, t: int,
                active: torch.Tensor) -> GmapState:
    b = _b(node.shape[0], node.device)
    s = _row_slot(st, node, active)
    trash = s == st.trash
    visited = st.visited.index_put((b, s), torch.where(trash, st.visited[:, -1],
                                                       True))
    step_ids = st.step_ids.index_put(
        (b, s), torch.where(trash, st.step_ids[:, -1], t + 1).to(torch.int32))
    return st.replace(visited=visited, step_ids=step_ids)


def update_embeds(st: GmapState, cur_node, avg_embed, cand_nodes, cand_embeds,
                  cand_valid, active) -> GmapState:
    """Visited current node: rewrite with the averaged pano embedding;
    unvisited candidates: accumulate their view embedding
    (agent.py:471-479, graph_utils.py:114-125).  Differentiable in the
    embeddings."""
    B, K = cand_nodes.shape
    b = _b(B, cand_nodes.device)
    s = _row_slot(st, cur_node, active)
    trash = s == st.trash
    emb_sum = st.emb_sum.index_put(
        (b, s), torch.where(trash[:, None], st.emb_sum[:, -1],
                            avg_embed.to(st.emb_sum.dtype)))
    emb_cnt = st.emb_cnt.index_put(
        (b, s), torch.where(trash, st.emb_cnt[:, -1], 1.0))

    d = _slot(st, cand_nodes)                                      # [B, K]
    d_vis = st.visited.gather(1, d.clamp(min=0).long())
    ok = cand_valid & active[:, None] & (d >= 0) & ~d_vis
    d_idx = torch.where(ok, d, st.trash).long()
    bk = b[:, None].expand(B, K)
    emb_sum = emb_sum.index_put(
        (bk, d_idx), torch.where(ok[:, :, None], cand_embeds.to(emb_sum.dtype),
                                 0.0), accumulate=True)
    emb_cnt = emb_cnt.index_put((bk, d_idx), ok.to(emb_cnt.dtype),
                                accumulate=True)
    return st.replace(emb_sum=emb_sum, emb_cnt=emb_cnt)


def node_embeds(st: GmapState) -> torch.Tensor:
    """[B, G+1, H] running-mean embeddings (get_node_embed)."""
    return st.emb_sum / torch.clamp(st.emb_cnt[:, :, None], min=1.0)


def follow_path(st: GmapState, src_node: torch.Tensor, dst_node: torch.Tensor,
                max_hops: int):
    """Observed-graph path src -> dst: (node ids after src [B, max_hops] i32,
    valid [B, max_hops]), the FloydGraph.path() equivalent
    (graph_utils.py:76-92) by next-hop chasing instead of recursive
    midpoints."""
    B = src_node.shape[0]
    b = _b(B, src_node.device)
    s = _slot(st, src_node[:, None])[:, 0]
    d = _slot(st, dst_node[:, None])[:, 0]
    cur = torch.where(s >= 0, s, st.trash).long()
    d = torch.where(d >= 0, d, st.trash).long()
    nodes, valid = [], []
    for _ in range(max_hops):
        done = cur == d
        nxt_slot = st.nxt[_item(st.nxt, b), cur, d].long()
        nxt_slot = torch.where(done | (nxt_slot < 0), cur, nxt_slot)
        valid.append(~done & (nxt_slot != cur))
        nodes.append(st.node_ids.gather(1, nxt_slot[:, None])[:, 0])
        cur = nxt_slot
    return torch.stack(nodes, dim=1), torch.stack(valid, dim=1)


def pair_dists(st: GmapState) -> torch.Tensor:
    """[B, G+1, G+1] observed distances with INF and the invalid slots
    zeroed: the input of the sprel attention bias (agent.py:137-141)."""
    d = torch.where(st.dist >= INF / 2, 0.0, st.dist)
    v = st.valid().to(d.dtype)
    return d * v[:, :, None] * v[:, None, :]
