"""One episode's topological map, as the DUET agent keeps it: plain numpy.

The released GraphMap (VLN-DUET map_nav_src/models/graph_utils.py) per
item: nodes in the order they are first seen, up to `capacity` (later
ones are dropped), straight-line edge weights from each visited node to
its candidates, and a Floyd relaxation through each node as it is
visited, with next hops and hop counts beside the distances; a path is
found by chasing next hops.  float32 distances, as the tables hold them.

One departure from the released map, which the program and the JAX
package both define: until the first relaxation the next-hop and hop
tables are the first item's of the batch, so an item's start-node edges
take the first item's next hops and hop counts (`first_item_tables`,
ROADMAP Queue 3).  `ItemMap(first_k=...)` starts from those tables.
"""

from __future__ import annotations

import numpy as np

INF = np.float32(1.0e9)
NO_HOPS = 10 ** 6


def first_item_tables(G1: int, first_k: int):
    """The next-hop and hop tables the first item leaves before the first
    relaxation: its start in slot 0 joined to its `first_k` candidates in
    slots 1..first_k."""
    nxt = np.full((G1, G1), -1, np.int64)
    np.fill_diagonal(nxt, np.arange(G1))
    hops = np.full((G1, G1), NO_HOPS, np.int64)
    np.fill_diagonal(hops, 0)
    for j in range(1, first_k + 1):
        nxt[0, j], nxt[j, 0] = j, 0
        hops[0, j] = hops[j, 0] = 1
    return nxt, hops


class ItemMap:
    def __init__(self, capacity: int, first_k: int):
        G1 = capacity + 1
        self.cap, self.trash = capacity, capacity
        self.node_ids = np.zeros(G1, np.int64)
        self.slot_of: dict[int, int] = {}
        self.count = 0
        self.visited = np.zeros(G1, bool)
        self.step_ids = np.zeros(G1, np.int64)
        self.dist = np.full((G1, G1), INF, np.float32)
        np.fill_diagonal(self.dist, 0.0)
        self.nxt, self.hops = first_item_tables(G1, first_k)
        self.stop_scores = np.full(G1, -np.inf, np.float32)
        self.relaxed = False

    def slot(self, node: int) -> int:
        return self.slot_of.get(int(node), -1)

    def add_nodes(self, nodes):
        for n in nodes:
            n = int(n)
            if n not in self.slot_of and self.count < self.cap:
                self.slot_of[n] = self.count
                self.node_ids[self.count] = n
                self.count += 1

    def add_edges(self, src: int, dsts, weights):
        s = self.slot(src)
        for d, w in zip(dsts, weights):
            d = self.slot(d)
            if s < 0 or d < 0 or not np.float32(w) < self.dist[s, d]:
                continue
            self.dist[s, d] = self.dist[d, s] = np.float32(w)
            if self.relaxed:  # before: the first item's tables stand
                self.nxt[s, d], self.nxt[d, s] = d, s
                self.hops[s, d] = self.hops[d, s] = 1

    def relax(self, node: int):
        k = self.slot(node)
        if k < 0:
            k = self.trash
        dk = self.dist[:, k]
        alt = dk[:, None] + dk[None, :]
        better = alt < self.dist
        better[self.trash, :] = False
        better[:, self.trash] = False
        hk = self.hops[:, k]
        self.dist = np.where(better, alt, self.dist)
        self.nxt = np.where(better, self.nxt[:, k][:, None], self.nxt)
        self.hops = np.where(better, hk[:, None] + hk[None, :], self.hops)
        self.relaxed = True

    def follow(self, src: int, dst: int, max_hops: int):
        """(node after each hop, hop taken) over `max_hops` hops."""
        cur = self.slot(src)
        cur = cur if cur >= 0 else self.trash
        d = self.slot(dst)
        d = d if d >= 0 else self.trash
        nodes, valid = [], []
        for _ in range(max_hops):
            done = cur == d
            nx = int(self.nxt[cur, d])
            if done or nx < 0:
                nx = cur
            valid.append(not done and nx != cur)
            nodes.append(int(self.node_ids[nx]))
            cur = nx
        return nodes, valid

    def path_to(self, src: int, dst: int, max_hops: int):
        """The hops appended for a move or a backtrack from src to dst:
        where the capped path misses dst, dst is forced into the last hop.
        Returns (all hop nodes, their flags, the appended nodes)."""
        nodes, valid = self.follow(src, dst, max_hops)
        if not any(v and n == dst for n, v in zip(nodes, valid)):
            nodes[-1], valid[-1] = int(dst), True
        return nodes, valid, [n for n, v in zip(nodes, valid) if v]

    def valid_slots(self) -> np.ndarray:
        return np.arange(self.cap + 1) < self.count

    def pair_dists(self) -> np.ndarray:
        d = np.where(self.dist >= INF / 2, 0.0, self.dist).astype(np.float32)
        v = self.valid_slots().astype(np.float32)
        return d * v[:, None] * v[None, :]

    def obs_dist_hops(self, cur_slot: int, slots):
        od = self.dist[cur_slot, slots]
        oh = self.hops[cur_slot, slots]
        return (np.where(od >= INF / 2, 0.0, od).astype(np.float32),
                np.where(oh >= 10 ** 5, 0, oh).astype(np.float32))
