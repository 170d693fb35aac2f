"""Plain float32 DUET-Imagine navigator (dynamic fusion, graph spatial
relations, bypass imagination) and the benchmark's counts of its work.

The model follows the released GlocalTextPathNavCMT (VLN-DUET map_nav_src/
models/vilmodel.py) as the configuration runs it: a 9-layer text encoder
once per episode, bypass imagination embeddings aligned to the noun
phrases, and per step the panorama (candidates, then the views no
candidate claims) through a 2-layer pre-norm encoder; a global branch over
[stop; map nodes] with a distance bias in its self-attention and a local
branch over [stop; panorama], each 4 cross-modal layers over [text;
imaginations]; a learned sigmoid mix of the two branches' logits, the
local candidates' logits merged into their map nodes.

`replay` walks a block of episodes along the program's served paths: at
each step it finds the map node the program moved to (the first node of
the path's next stretch not yet visited; intermediate hops are visited
nodes by construction), or that it stopped (then the rest of the path is
its backtrack to its best stop score), checks that each appended stretch
is the map's own path there, and reads how far the logit of the
program's choice lies below the reference's best.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import (
    LOGIT_NEG,
    Numerics,
    Specs,
    bert_attention,
    bert_layer,
    ext_mask,
    ffn,
    layer_norm,
    linear,
    snap_view,
    softmax_attention,
    view_elevation,
    view_heading,
    x_attention,
)
from portbench.reference.gmap import ItemMap
from portbench.reference.hamt import (
    PROJ,
    _bert_specs,
    attn_bytes,
    bert_layer_flops,
    cross_flops,
)
from portbench.reference.hamt import obs_counts as hamt_obs_counts

MAX_TELEPORT_HOPS = 6
MAX_BACKTRACK_HOPS = 8


def _x_specs(S: Specs, p: str, H: int, F_: int):
    for n in ("query", "key", "value"):
        S.linear(f"{p}.visual_attention.att.{n}", H, H)
    S.linear(f"{p}.visual_attention.output.dense", H, H)
    S.norm(f"{p}.visual_attention.output.LayerNorm", H)
    for n in ("query", "key", "value"):
        S.linear(f"{p}.visn_self_att.self.{n}", H, H)
    S.linear(f"{p}.visn_self_att.output.dense", H, H)
    S.norm(f"{p}.visn_self_att.output.LayerNorm", H)
    S.linear(f"{p}.visn_inter.dense", H, F_)
    S.linear(f"{p}.visn_output.dense", F_, H)
    S.norm(f"{p}.visn_output.LayerNorm", H)


def _cls_specs(S: Specs, p: str, n_in: int, H: int):
    S.linear(f"{p}.net.0", n_in, H)
    S.norm(f"{p}.net.2", H)
    S.linear(f"{p}.net.3", H, 1)


def specs(m: dict) -> Specs:
    """Every parameter of the navigator at the widths of `m`."""
    H, F_, Df, A = (m["hidden_size"], m["intermediate_size"],
                    m["image_feat_size"], m["angle_feat_size"])
    S = Specs()
    S.embed("embeddings.word_embeddings", m["vocab_size"], H)
    S.embed("embeddings.position_embeddings", m["max_position_embeddings"], H)
    S.embed("embeddings.token_type_embeddings", m["type_vocab_size"], H)
    S.norm("embeddings.LayerNorm", H)
    for i in range(m["num_l_layers"]):
        _bert_specs(S, f"lang_encoder.layer.{i}", H, F_)
    e = "img_embeddings"
    S.linear(f"{e}.img_linear", Df, H)
    S.norm(f"{e}.img_layer_norm", H)
    S.linear(f"{e}.loc_linear", A + 3, H)
    S.norm(f"{e}.loc_layer_norm", H)
    S.embed(f"{e}.nav_type_embedding", 3, H)
    S.norm(f"{e}.layer_norm", H)
    for i in range(m["num_pano_layers"]):
        p = f"{e}.pano_encoder.layers.{i}"
        S[f"{p}.self_attn.in_proj_weight"] = ((3 * H, H), "linear")
        S[f"{p}.self_attn.in_proj_bias"] = ((3 * H,), "bias")
        S.linear(f"{p}.self_attn.out_proj", H, H)
        S.linear(f"{p}.linear1", H, F_)
        S.linear(f"{p}.linear2", F_, H)
        S.norm(f"{p}.norm1", H)
        S.norm(f"{p}.norm2", H)
    S.norm(f"{e}.pano_encoder.norm", H)
    S.linear("local_encoder.vp_pos_embeddings.0", 2 * (A + 3), H)
    S.norm("local_encoder.vp_pos_embeddings.1", H)
    for i in range(m["num_x_layers"]):
        _x_specs(S, f"local_encoder.encoder.x_layers.{i}", H, F_)
    S.linear("global_encoder.gmap_pos_embeddings.0", A + 3, H)
    S.norm("global_encoder.gmap_pos_embeddings.1", H)
    S.embed("global_encoder.gmap_step_embeddings", m["max_action_steps"], H)
    S.linear("global_encoder.sprel_linear", 1, 1)
    for i in range(m["num_x_layers"]):
        _x_specs(S, f"global_encoder.encoder.x_layers.{i}", H, F_)
    _cls_specs(S, "global_sap_head", H, H)
    _cls_specs(S, "local_sap_head", H, H)
    _cls_specs(S, "sap_fuse_linear", 2 * H, H)
    S.embed("imagine_embeddings.type_embedding", 1, H)
    p = "contrastive_alignment_model.image_proj"
    S.linear(f"{p}.fc1", H, PROJ, bias=False)
    S.linear(f"{p}.fc2", PROJ, PROJ, bias=False)
    S.linear(f"{p}.fc3", PROJ, H, bias=False)
    return S


class Duet:
    """The navigator's modes over weights `P` at widths `m`."""

    def __init__(self, P: dict, m: dict, num: Numerics):
        self.P, self.m, self.num = P, m, num
        self.heads = m["num_attention_heads"]

    def _lin(self, name, x):
        return linear(self.P, name, x, self.num)

    def _cls(self, p, x):
        x = layer_norm(self.P, f"{p}.net.2", F.relu(self._lin(f"{p}.net.0", x)))
        return self._lin(f"{p}.net.3", x)[..., 0]

    def text(self, ids, mask):
        P = self.P
        L = ids.shape[1]
        x = (P["embeddings.word_embeddings.weight"][ids]
             + P["embeddings.position_embeddings.weight"][:L][None]
             + P["embeddings.token_type_embeddings.weight"][0])
        x = layer_norm(P, "embeddings.LayerNorm", x)
        ext = ext_mask(mask)
        for i in range(self.m["num_l_layers"]):
            x = bert_layer(P, f"lang_encoder.layer.{i}", x, ext, self.heads, self.num)
        return x

    def imagine(self, feats, imagine_mask, np_weights):
        x = feats + self.P["imagine_embeddings.type_embedding.weight"][0]
        p = "contrastive_alignment_model.image_proj"
        proj = self._lin(f"{p}.fc3", F.relu(self._lin(
            f"{p}.fc2", F.relu(self._lin(f"{p}.fc1", x)))))
        valid = imagine_mask & (np_weights.sum(-1) > 0)
        return torch.where(valid[:, :, None], proj, x)

    def panorama(self, img, loc, nav, valid):
        P, e, num = self.P, "img_embeddings", self.num
        x = (layer_norm(P, f"{e}.img_layer_norm", self._lin(f"{e}.img_linear", img))
             + layer_norm(P, f"{e}.loc_layer_norm", self._lin(f"{e}.loc_linear", loc))
             + P[f"{e}.nav_type_embedding.weight"][nav]
             + P["embeddings.token_type_embeddings.weight"][1])
        x = layer_norm(P, f"{e}.layer_norm", x)
        bias = torch.where(valid, 0.0, -1e9)[:, None, None, :]
        for i in range(self.m["num_pano_layers"]):
            p = f"{e}.pano_encoder.layers.{i}"
            h = layer_norm(P, f"{p}.norm1", x, 1e-5)
            qkv = (num.matmul_weight(h, P[f"{p}.self_attn.in_proj_weight"])
                   + P[f"{p}.self_attn.in_proj_bias"])
            q, k, v = qkv.chunk(3, dim=-1)
            x = x + self._lin(f"{p}.self_attn.out_proj",
                              softmax_attention(q, k, v, bias, self.heads))
            h = F.gelu(self._lin(f"{p}.linear1", layer_norm(P, f"{p}.norm2", x, 1e-5)))
            x = x + self._lin(f"{p}.linear2", h)
        return layer_norm(P, f"{e}.pano_encoder.norm", x)

    def _branch(self, p, ctx, ctx_mask, x, x_valid, bias=None):
        ext_ctx, ext_x = ext_mask(ctx_mask), ext_mask(x_valid)
        for i in range(self.m["num_x_layers"]):
            q = f"{p}.x_layers.{i}"
            xx = x_attention(self.P, f"{q}.visual_attention", x, ctx, ext_ctx,
                             self.heads, self.num)
            xs = bert_attention(self.P, f"{q}.visn_self_att", xx, ext_x,
                                self.heads, self.num, bias=bias)
            x = ffn(self.P, f"{q}.visn_inter", f"{q}.visn_output", xs, self.num)
        return x

    def navigate(self, ctx, ctx_mask, gmap_img, gmap_step, gmap_pos, gmap_valid,
                 pair, gmap_visited, vp_img, vp_pos, vp_valid, vp_nav_valid, c2g):
        """The fused action logits [B, 1 + G] ([stop; map slots])."""
        P = self.P
        g = (gmap_img + P["global_encoder.gmap_step_embeddings.weight"][gmap_step]
             + layer_norm(P, "global_encoder.gmap_pos_embeddings.1",
                          self._lin("global_encoder.gmap_pos_embeddings.0", gmap_pos)))
        w = P["global_encoder.sprel_linear.weight"][0, 0]
        sprels = (pair * w + P["global_encoder.sprel_linear.bias"][0])[:, None]
        vp = vp_img + layer_norm(P, "local_encoder.vp_pos_embeddings.1",
                                 self._lin("local_encoder.vp_pos_embeddings.0", vp_pos))
        g = self._branch("global_encoder.encoder", ctx, ctx_mask, g, gmap_valid,
                         sprels)
        vp = self._branch("local_encoder.encoder", ctx, ctx_mask, vp, vp_valid)
        fuse = torch.sigmoid(self._cls("sap_fuse_linear",
                                       torch.cat([g[:, 0], vp[:, 0]], -1)))[:, None]
        glob = torch.where(~gmap_visited & gmap_valid,
                           self._cls("global_sap_head", g) * fuse, LOGIT_NEG)
        loc = torch.where(vp_nav_valid, self._cls("local_sap_head", vp) * (1 - fuse),
                          LOGIT_NEG)
        return merge(glob, loc, gmap_visited, gmap_valid, vp_nav_valid, c2g)


def merge(glob, loc, visited, valid, nav_valid, c2g):
    """The local candidates' logits into their map nodes: stop adds the
    local stop; a candidate on a visited node adds to a shared backtrack
    logit, which every unvisited node without a candidate of its own takes."""
    out = glob.clone()
    out[:, 0] = out[:, 0] + loc[:, 0]
    cand = nav_valid.clone()
    cand[:, 0] = False
    val = torch.where(cand, loc, 0.0)
    c2g = c2g.float()
    on_visited = torch.einsum("bgj,bg->bj", c2g, (visited & valid).float()) > 0
    bw = torch.where(on_visited & cand, val, 0.0).sum(1)
    fresh = cand & ~on_visited
    contrib = torch.einsum("bgj,bj->bg", c2g, torch.where(fresh, val, 0.0))
    has = torch.einsum("bgj,bj->bg", c2g, fresh.float()) > 0
    open_ = valid & ~visited
    open_[:, 0] = False
    return out + torch.where(has, contrib, bw[:, None]) * open_


def observe(tab, feat, scan, node, view):
    """Candidates then views (no STOP token); loc = angles and a unit box."""
    cand_img, cand_ang, node_feat, pano_ang, valid, claimed = tab.see(
        feat, scan, node, view)
    B, V = scan.shape[0], tab.views
    img = torch.cat([cand_img, node_feat], 1)
    ang = torch.cat([cand_ang, pano_ang], 1)
    ok = torch.cat([valid, ~claimed], 1)
    loc = torch.cat([ang, torch.ones_like(ang[..., :3])], -1) * ok[:, :, None]
    nav = torch.cat([valid.long(), torch.zeros((B, V), dtype=torch.long,
                                               device=scan.device)], 1)
    return img, loc, nav, ok


def rel_pos(xyz, cur, heading, elev, targets, od, oh):
    """7-d position of each target seen from the current pose (numpy):
    angles of the direction, then straight, observed and hop distances."""
    d = xyz[targets] - xyz[cur]
    dist = np.maximum(np.linalg.norm(d, axis=-1), 1e-8)
    h = np.arctan2(d[:, 0], d[:, 1]) - heading
    e = np.arcsin(np.clip(d[:, 2] / dist, -1, 1)) - elev
    return np.stack([np.sin(h), np.cos(h), np.sin(e), np.cos(e), dist / 30.0,
                     od / 30.0, oh / 10.0], -1).astype(np.float32)


class Replay:
    """Reference state of a block of items along their served paths."""

    def __init__(self, model: Duet, tab, feat, ep: dict, first_k, e: dict):
        self.model, self.tab, self.feat, self.ep = model, tab, feat, ep
        self.T, self.G = e["max_action_len"], e["max_gmap_nodes"]
        self.dev = feat.device
        self.maps = [ItemMap(self.G, int(k)) for k in first_k]
        self.start = ep["start_node"].cpu().numpy()
        # (item, step) -> (logits chosen from, choice, map nodes)
        self.decisions = {}
        self.stops = {}  # item -> (log stop scores, the slot backtracked to)
        self.xyz = tab.node_xyz.cpu().numpy()
        self.adj = tab.np_adj
        self.pointid = tab.pointid.cpu().numpy()

    def _grow(self, b, scan, node):
        mp, tab = self.maps[b], self.tab
        cands = self.adj[scan, node][tab.np_valid[scan, node]]
        mp.add_nodes([node])
        mp.add_nodes(cands)
        w = np.linalg.norm(self.xyz[scan, cands] - self.xyz[scan, node], axis=-1)
        mp.add_edges(node, cands, w.astype(np.float32))
        mp.relax(node)

    @torch.no_grad()
    def run(self, paths, lens):
        """Replays the block; returns the number of items whose path is not
        the map's.  `decisions[item, step]` keeps the logits of each step
        the model chose (masked to the open actions) with the program's
        choice and the map's size, `stops[item]` the log stop scores its backtrack chose from
        with the program's pick."""
        model, tab, ep, T, G, dev = (self.model, self.tab, self.ep, self.T,
                                     self.G, self.dev)
        B = len(self.maps)
        K, V = tab.K, tab.views
        scan_t = ep["scan"].long()
        scan = ep["scan"].cpu().numpy()
        node = ep["start_node"].cpu().numpy().astype(np.int64)
        view = snap_view(ep["start_heading"], V).cpu().numpy()
        txt = model.text(ep["txt_ids"].long(), ep["txt_mask"])
        imag = model.imagine(ep["imagine_feats"], ep["imagine_mask"], ep["np_weights"])
        ctx = torch.cat([txt, imag], 1)
        ctx_mask = torch.cat([ep["txt_mask"], ep["imagine_mask"]], 1)
        H = txt.shape[-1]
        emb_sum = torch.zeros((B, G + 1, H), device=dev)
        emb_cnt = torch.zeros((B, G + 1), device=dev)
        ended = np.zeros(B, bool)
        bad = np.zeros(B, bool)
        ptr = np.ones(B, np.int64)
        for b in range(B):
            self._grow(b, scan[b], node[b])
        for t in range(T):
            act = ~ended & ~bad
            if not act.any():
                break
            for b in np.flatnonzero(act):
                mp = self.maps[b]
                s = mp.slot(node[b])
                if s >= 0:
                    mp.visited[s], mp.step_ids[s] = True, t + 1
            node_t = torch.as_tensor(node, device=dev)
            img, loc, nav, ok = observe(tab, self.feat, scan_t, node_t,
                                        torch.as_tensor(view, device=dev))
            pano = model.panorama(img, loc, nav, ok)
            avg = (pano * ok[:, :, None]).sum(1) / ok.sum(1, keepdim=True).clamp(min=1)
            # inputs of every item; those not active are computed and unread
            gpos = np.zeros((B, G + 1, 7), np.float32)
            pair = np.zeros((B, G + 1, G + 1), np.float32)
            gvalid = np.zeros((B, G + 1), bool)
            gvisit = np.zeros((B, G + 1), bool)
            gstep = np.zeros((B, G + 1), np.int64)
            vpos = np.zeros((B, K + V + 1, 14), np.float32)
            c2g = np.zeros((B, G + 1, K + V + 1), bool)
            cand_valid = tab.np_valid[scan, node]
            cand_nodes = self.adj[scan, node]
            for b in range(B):
                mp = self.maps[b]
                cur = mp.slot(node[b])
                if act[b] and cur >= 0:
                    emb_sum[b, cur], emb_cnt[b, cur] = avg[b], 1.0
                    for k in np.flatnonzero(cand_valid[b]):
                        d = mp.slot(cand_nodes[b, k])
                        if d >= 0 and not mp.visited[d]:
                            emb_sum[b, d] += pano[b, k]
                            emb_cnt[b, d] += 1.0
                n = mp.count
                gvalid[b, 0], gvalid[b, 1:n + 1] = True, True
                gvisit[b, 1:n + 1] = mp.visited[:n]
                gstep[b, 1:n + 1] = mp.step_ids[:n]
                hd = view_heading(view[b], V)
                el = view_elevation(view[b], V)
                cs = cur if cur >= 0 else mp.trash
                od, oh = mp.obs_dist_hops(cs, np.arange(n))
                gpos[b, 1:n + 1] = rel_pos(self.xyz[scan[b]], node[b], hd, el,
                                           mp.node_ids[:n], od, oh)
                pair[b, 1:, 1:] = mp.pair_dists()[:G, :G]
                tgt = np.concatenate([[self.start[b]], cand_nodes[b]])
                ts = np.array([mp.slot(x) for x in tgt])
                od, oh = mp.obs_dist_hops(cs, np.where(ts >= 0, ts, mp.trash))
                p7 = rel_pos(self.xyz[scan[b]], node[b], hd, el, tgt, od, oh)
                vpos[b, :, :7] = p7[0]
                vpos[b, 1:K + 1, 7:] = p7[1:] * cand_valid[b][:, None]
                for k in np.flatnonzero(cand_valid[b]):
                    d = ts[1 + k]
                    if d >= 0:
                        c2g[b, d + 1, k + 1] = True
            t_ = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
            gmap_img = F.pad(emb_sum[:, :G] / emb_cnt[:, :G, None].clamp(min=1.0),
                             (0, 0, 1, 0))
            ones = torch.ones((B, 1), dtype=torch.bool, device=dev)
            logits = model.navigate(
                ctx, ctx_mask, gmap_img, t_(gstep), t_(gpos), t_(gvalid),
                t_(pair), t_(gvisit), F.pad(pano, (0, 0, 1, 0)), t_(vpos),
                torch.cat([ones, ok], 1), torch.cat([ones, nav == 1], 1), t_(c2g))
            probs = torch.softmax(logits, -1)[:, 0].cpu().numpy()
            lg = logits.cpu().numpy()
            for b in np.flatnonzero(act):
                mp = self.maps[b]
                cur = mp.slot(node[b])
                if cur >= 0:
                    mp.stop_scores[cur] = probs[b]
                rest = [int(x) for x in paths[b, ptr[b]:lens[b]]]
                fresh = [i for i, x in enumerate(rest)
                         if mp.slot(x) < 0 or not mp.visited[mp.slot(x)]]
                open_ = gvalid[b, 1:] & ~gvisit[b, 1:]
                forced = t == T - 1 or not open_.any()
                choice = 0
                if fresh and not forced:
                    tgt = rest[fresh[0]]
                    choice = mp.slot(tgt) + 1
                    hops, valid, seg = mp.path_to(int(node[b]), tgt,
                                                  MAX_TELEPORT_HOPS)
                    if choice <= 0 or seg != rest[:fresh[0] + 1]:
                        bad[b] = True
                        continue
                    ptr[b] += len(seg)
                    n_hops = sum(valid)
                    prev = hops[n_hops - 2] if n_hops >= 2 else int(node[b])
                    match = np.flatnonzero(self.adj[scan[b], prev] == tgt)
                    view[b] = self.pointid[scan[b], prev, match[0] if len(match) else 0]
                    node[b] = tgt
                elif fresh:
                    bad[b] = True  # a forced stop moved on
                    continue
                else:
                    # stop scores as log-probabilities, so that their gaps
                    # read on the scale of the logits'
                    scored = np.where(mp.valid_slots() & mp.visited,
                                      np.log(np.maximum(mp.stop_scores, 1e-30)),
                                      -np.inf)
                    back = rest[-1] if rest else int(node[b])
                    if np.isfinite(scored).any():
                        self.stops[b] = (scored, mp.slot(back))
                    if rest:
                        _, _, seg = mp.path_to(int(node[b]), back, MAX_BACKTRACK_HOPS)
                        if seg != rest:
                            bad[b] = True
                            continue
                    ptr[b] = lens[b]
                    ended[b] = True
                if not forced:
                    ok_act = np.concatenate([[True], open_])
                    self.decisions[b, t] = (np.where(ok_act, lg[b], -np.inf),
                                            choice, mp.count)
            for b in np.flatnonzero(~ended & ~bad):
                self._grow(b, scan[b], node[b])
        bad |= ~ended
        return int(bad.sum())


# ------------------------------------------------------------------ census

def census(m: dict, lt, li, lp, steps):
    """(flops, attention bytes) that episodes need: per item its text
    length `lt`, imaginations `li` (of them `lp` with a noun phrase), and
    per step it ran (`steps`: [(pano tokens, navigable, map nodes), ...]
    for each item)."""
    H, F_, Df, A = (m["hidden_size"], m["intermediate_size"],
                    m["image_feat_size"], m["angle_feat_size"])
    nl, nx, npn = m["num_l_layers"], m["num_x_layers"], m["num_pano_layers"]
    flops = nbytes = 0.0
    for b, item in enumerate(steps):
        Lt, Ll = float(lt[b]), float(lt[b] + li[b])
        flops += nl * bert_layer_flops(Lt, H, F_) + 2 * lp[b] * (
            H * PROJ + PROJ * PROJ + PROJ * H) + 2 * lp[b] * Lt * H
        nbytes += nl * attn_bytes(Lt, Lt, H)
        for ov, nav, g in item:
            gl, vl = g + 1.0, ov + 1.0
            flops += (2 * ov * (Df + A + 3) * H + npn * bert_layer_flops(ov, H, F_)
                      + 2 * gl * (A + 3) * H + 2 * vl * 2 * (A + 3) * H
                      + nx * (cross_flops(gl, Ll, H) + bert_layer_flops(gl, H, F_)
                              + cross_flops(vl, Ll, H) + bert_layer_flops(vl, H, F_))
                      + 2 * (gl + nav + 1) * (H * H + H) + 2 * 2 * H * H)
            nbytes += (npn * attn_bytes(ov, ov, H)
                       + nx * (attn_bytes(gl, Ll, H) + attn_bytes(gl, gl, H)
                               + 4 * gl * gl
                               + attn_bytes(vl, Ll, H) + attn_bytes(vl, vl, H)))
    return flops, nbytes



def walk(tab, scan, start, paths, lens, T: int, G: int):
    """Per served item, per step it ran: (panorama tokens read, candidates,
    map nodes).  Decodes the moves as `Replay` does, from the visited set
    alone (no model): what the census needs."""
    nv = tab.np_valid.sum(-1)
    obs_tok = hamt_obs_counts(tab)[0] - 1  # no STOP token in DUET's panorama
    out = []
    for b in range(len(start)):
        s, node = int(scan[b]), int(start[b])
        seen = {node}
        seen.update(int(x) for x in tab.np_adj[s, node][tab.np_valid[s, node]])
        count = min(len(seen), G)
        visited, ptr, steps = {node}, 1, []
        for t in range(T):
            steps.append((float(obs_tok[s, node]), float(nv[s, node]), float(count)))
            rest = [int(x) for x in paths[b, ptr:lens[b]]]
            fresh = [i for i, x in enumerate(rest) if x not in visited]
            if not fresh or t == T - 1 or len(visited) >= count:
                break
            ptr += fresh[0] + 1
            node = rest[fresh[0]]
            visited.add(node)
            for x in tab.np_adj[s, node][tab.np_valid[s, node]]:
                if int(x) not in seen and count < G:
                    seen.add(int(x))
                    count += 1
        out.append(steps)
    return out
