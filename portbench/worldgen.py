"""The benchmark's own synthetic world and episodes, from a seed.

A frozen numpy copy of `vln_imagine_tpu_torch/envx/synthetic.py`
(`random_scan_graph`, `synthetic_episodes`) and of the compiler's
Floyd-Warshall: jittered-grid viewpoint graphs with R2R-like degree, edge
lengths and path lengths, and episodes whose start and goal lie 2 to P-1
hops apart.  Instruction lengths and imaginations an episode follow the
published R2R and FG-R2R statistics named in the traffic file.  It imports nothing of the program, so the yardstick stays put
when the program's generator changes.  View and imagination features are
not drawn here: `draw_features` makes them on the device in one call each.

Graphs come back as plain tuples (name, xyz [n, 3], sorted edges); the
program compiles them through its own `compile_world`, the reference
through `reference/world.py`.
"""

from __future__ import annotations

import numpy as np
import torch

INF = 1.0e9


def random_scan_graph(rng: np.random.Generator, name: str, num_nodes: int,
                      edge_len: float = 2.25):
    """Nodes on a jittered grid, edges to the 2-3 nearest neighbours, the
    components stitched together by their closest pair."""
    side = max(2, int(np.ceil(np.sqrt(num_nodes))))
    cells = rng.permutation(side * side)[:num_nodes]
    xy = np.stack([cells // side, cells % side], 1).astype(np.float64)
    xy = (xy + rng.uniform(0.15, 0.85, xy.shape)) * edge_len
    z = rng.uniform(-0.3, 0.3, (num_nodes, 1))
    xyz = np.concatenate([xy, z], 1)

    d2 = ((xyz[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    edges = set()
    for i in range(num_nodes):
        k = int(rng.integers(2, 4))
        for j in np.argsort(d2[i])[:k]:
            edges.add((min(i, int(j)), max(i, int(j))))
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
    return name, xyz, sorted(edges)


def floyd_warshall(n: int, edges, xyz: np.ndarray):
    """All-pairs geodesic distance, next hop and hop count."""
    dist = np.full((n, n), INF, np.float64)
    nxt = np.full((n, n), -1, np.int64)
    hops = np.full((n, n), 10 ** 6, np.int64)
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


def scan_graphs(seed: int, num_scans: int, num_nodes: int):
    """The world's graphs and each scan's (next hop, hops) tables."""
    rng = np.random.default_rng([seed, 0])
    graphs = [random_scan_graph(rng, f"scan{s}", num_nodes)
              for s in range(num_scans)]
    paths = [floyd_warshall(len(xyz), edges, xyz)[1:] for _, xyz, edges in graphs]
    return graphs, paths


def instruction_sizes(instr: dict, count: int, max_instr_len: int,
                      max_imaginations: int):
    """Text tokens and sub-instructions of `count` episodes, drawn from the
    traffic's `instructions` block and its own `sizes_seed`: the same sizes
    for every run.  Words are log-normal about R2R's published mean, tokens
    are words x `tokens_per_word` plus [CLS] and [SEP], cut at the
    configuration's `max_instr_len` as the program cuts them; the
    sub-instructions (one imagination each) are 1 + Poisson about their
    published mean, scaled by the instruction's share of the mean words."""
    rng = np.random.default_rng([instr["sizes_seed"], 3])
    mean, sigma = instr["words_mean"], instr["words_log_sigma"]
    words = rng.lognormal(np.log(mean) - sigma ** 2 / 2, sigma, count)
    tokens = np.rint(words * instr["tokens_per_word"]) + instr["special_tokens"]
    tokens = np.clip(tokens, 4, max_instr_len).astype(np.int64)
    subs = 1 + rng.poisson((instr["sub_instructions_mean"] - 1) * words / mean)
    subs = np.minimum(subs, np.minimum(max_imaginations, tokens - 1))
    return tokens, subs.astype(np.int64)


def episodes(seed: int, paths, num_nodes: int, count: int, max_gt_path_len: int,
             max_instr_len: int, max_imaginations: int, vocab_size: int,
             instr: dict, min_hops: int = 2) -> dict[str, np.ndarray]:
    """`count` R2R-like episodes as numpy arrays, with the field names of
    the program's EpisodeBatch (imagination features excepted).  The seed
    draws the graphs' paths, the token ids and the order of the sizes."""
    rng = np.random.default_rng([seed, 1])
    S, P = len(paths), max_gt_path_len
    scans = rng.integers(0, S, count)
    gt_path = np.zeros((count, P), np.int64)
    gt_len = np.zeros(count, np.int64)
    nodes = np.arange(num_nodes)
    for b in range(count):
        nxt, hops = paths[scans[b]]
        while True:
            st = rng.choice(nodes)
            ok = nodes[(hops[st] >= min_hops) & (hops[st] <= P - 1)]
            if len(ok):
                gl = rng.choice(ok)
                break
        path = [st]
        while path[-1] != gl:
            path.append(nxt[path[-1], gl])
        gt_len[b] = len(path)
        gt_path[b, :len(path)] = path
        gt_path[b, len(path):] = gl

    L, I = max_instr_len, max_imaginations
    tokens, subs = instruction_sizes(instr, count, L, I)
    order = rng.permutation(count)
    txt_len, n_sub = tokens[order], subs[order]
    txt_ids = rng.integers(4, vocab_size, (count, L))
    txt_mask = np.arange(L)[None, :] < txt_len[:, None]
    txt_ids = np.where(txt_mask, txt_ids, 0)
    txt_ids[:, 0] = 1

    imagine_mask = ((np.arange(I)[None, :] < n_sub[:, None])
                    & (rng.random((count, I)) < instr["imagined_share"]))
    np_weights = np.zeros((count, I, L), np.float32)
    for b in range(count):
        bounds = np.linspace(1, txt_len[b], n_sub[b] + 1).astype(int)
        for i in range(n_sub[b]):
            if not imagine_mask[b, i]:
                continue
            lo, hi = bounds[i], max(bounds[i] + 1, bounds[i + 1])
            span = rng.integers(1, min(3, hi - lo) + 1)
            s0 = rng.integers(lo, hi - span + 1)
            np_weights[b, i, s0:s0 + span] = 1.0 / span

    return dict(
        scan=scans.astype(np.int32),
        start_node=gt_path[:, 0].astype(np.int32),
        start_heading=rng.uniform(0, 2 * np.pi, count).astype(np.float32),
        gt_path=gt_path.astype(np.int32),
        gt_len=gt_len.astype(np.int32),
        txt_ids=txt_ids.astype(np.int32),
        txt_mask=txt_mask,
        imagine_mask=imagine_mask,
        np_weights=np_weights,
    )


def draw_features(seed: int, shape, device, stream: int) -> torch.Tensor:
    """N(0, 0.25) features of `shape` drawn on `device` in one call, from
    a generator keyed on (seed, stream)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return torch.randn(shape, generator=gen, device=device) * 0.5
