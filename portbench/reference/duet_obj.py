"""Plain float32 DUET-Imagine with detector objects (SOON, REVERIE), and
the benchmark's counts of its work.

The release (VLN-DUET map_nav_src/models/vilmodel.py: `ImageEmbeddings`,
`forward_panorama_per_step`, `GlocalTextPathNavCMT`'s `og_head`; the object
agents' node stop scores): each viewpoint's detected objects join the
panorama as tokens of their own after the views, embedded through
`obj_linear` / `obj_layer_norm` where their width differs from the views'
(SOON's 2,048-d BUTD features beside 768-d ViT views), through the views'
`img_linear` / `img_layer_norm` where it does not (REVERIE).  With location
features and the navigation type 2 they go through the pano encoder, into
the viewpoint's mean embedding, and through the local branch, where
`og_head` scores each of them.  The agent keeps the best-scored object of
each node with the node's stop score, the last time it stood there, and
grounds with the one kept at the node it ends on, after the stop
backtrack.

Departures from the release, each the port's too:
- the panorama is one fixed-size bank, [candidates; views; objects] with
  masks, where the release packs each item's valid views then its valid
  objects; the pano encoder has no positions, so only the masks matter;
- an object's location features are the angles of its heading and
  elevation from the current view and the views' unit box, where the
  release's agent gives it its detector box.

`Replay` is `duet.Replay` with the object tokens in each step's panorama
and the grounding kept per node; its loop repeats the DUET replay's.
`census` counts the DUET census's work with every valid object token in
the panorama and the local branch, their own projection and the og head.
Nothing of the program and no JAX is imported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import duet
from portbench.reference.common import (
    angle_feature,
    f32_setup,
    layer_norm,
    softmax_attention,
    snap_view,
    view_elevation,
    view_heading,
)
from portbench.reference.duet import MAX_BACKTRACK_HOPS, MAX_TELEPORT_HOPS, rel_pos


def specs(m: dict):
    """The DUET navigator's parameters with the object projection (where
    the object width differs from the views') and the og head."""
    S = duet.specs(m)
    H, Do = m["hidden_size"], m["obj_feat_size"]
    if Do != m["image_feat_size"]:
        S.linear("img_embeddings.obj_linear", Do, H)
        S.norm("img_embeddings.obj_layer_norm", H)
    duet._cls_specs(S, "og_head", H, H)
    return S


class ObjDuet(duet.Duet):
    """`duet.Duet` with object tokens in the panorama and the og head."""

    def panorama_objects(self, img, obj, loc, nav, valid):
        """[B, K+V, Df] views and [B, Ko, Do] objects (+ loc, nav types and
        validity over both) -> pano token embeddings."""
        P, e = self.P, "img_embeddings"
        views = layer_norm(P, f"{e}.img_layer_norm", self._lin(f"{e}.img_linear", img))
        if f"{e}.obj_linear.weight" in P:
            objs = layer_norm(P, f"{e}.obj_layer_norm", self._lin(f"{e}.obj_linear", obj))
        else:
            objs = layer_norm(P, f"{e}.img_layer_norm", self._lin(f"{e}.img_linear", obj))
        x = (torch.cat([views, objs], 1)
             + layer_norm(P, f"{e}.loc_layer_norm", self._lin(f"{e}.loc_linear", loc))
             + P[f"{e}.nav_type_embedding.weight"][nav]
             + P["embeddings.token_type_embeddings.weight"][1])
        x = layer_norm(P, f"{e}.layer_norm", x)
        bias = torch.where(valid, 0.0, -1e9)[:, None, None, :]
        for i in range(self.m["num_pano_layers"]):
            p = f"{e}.pano_encoder.layers.{i}"
            h = layer_norm(P, f"{p}.norm1", x, 1e-5)
            qkv = (self.num.matmul_weight(h, P[f"{p}.self_attn.in_proj_weight"])
                   + P[f"{p}.self_attn.in_proj_bias"])
            q, k, v = qkv.chunk(3, dim=-1)
            x = x + self._lin(f"{p}.self_attn.out_proj",
                              softmax_attention(q, k, v, bias, self.heads))
            h = F.gelu(self._lin(f"{p}.linear1", layer_norm(P, f"{p}.norm2", x, 1e-5)))
            x = x + self._lin(f"{p}.linear2", h)
        return layer_norm(P, f"{e}.pano_encoder.norm", x)

    def ground(self, ctx, ctx_mask, vp_img, vp_pos, vp_valid):
        """The og head over the local branch's tokens [B, 1 + T_pano]."""
        vp = vp_img + layer_norm(self.P, "local_encoder.vp_pos_embeddings.1",
                                 self._lin("local_encoder.vp_pos_embeddings.0", vp_pos))
        vp = self._branch("local_encoder.encoder", ctx, ctx_mask, vp, vp_valid)
        return self._cls("og_head", vp)


def objects_at(obj: dict, scan, node, view, views: int):
    """A node's object tokens: features (zero where invalid), location
    features (angles from the current heading, a unit box), navigation
    types, validity and ids."""
    valid = obj["valid"][scan, node]                            # [B, Ko]
    ang = obj["ang"][scan, node]
    base = view_heading(view, views)[:, None]
    a = angle_feature(ang[..., 0] - base, ang[..., 1])
    loc = torch.cat([a, torch.ones_like(a[..., :3])], -1) * valid[..., None]
    img = obj["feat"][scan, node] * valid[..., None]
    return img, loc, 2 * valid.long(), valid, obj["ids"][scan, node]


class Replay(duet.Replay):
    """The DUET replay with objects.  `ground[item]` maps each node the
    item stood on to the og logits of its objects there (-inf where
    invalid) and their ids, the last time it stood there.  float32
    matmuls run without TF32."""

    def __init__(self, model: ObjDuet, tab, feat, obj: dict, ep: dict, first_k,
                 e: dict):
        f32_setup()
        super().__init__(model, tab, feat, ep, first_k, e)
        self.obj = obj
        self.ground = [dict() for _ in self.maps]

    @torch.no_grad()
    def run(self, paths, lens):
        model, tab, ep, T, G, dev = (self.model, self.tab, self.ep, self.T,
                                     self.G, self.dev)
        B = len(self.maps)
        K, V = tab.K, tab.views
        Ko = self.obj["valid"].shape[-1]
        Tp = K + V + Ko
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
            view_t = torch.as_tensor(view, device=dev)
            img, loc, nav, ok = duet.observe(tab, self.feat, scan_t, node_t, view_t)
            oimg, oloc, onav, ook, oids = objects_at(self.obj, scan_t, node_t,
                                                     view_t, V)
            loc, nav, ok = (torch.cat([loc, oloc], 1), torch.cat([nav, onav], 1),
                            torch.cat([ok, ook], 1))
            pano = model.panorama_objects(img, oimg, loc, nav, ok)
            avg = (pano * ok[:, :, None]).sum(1) / ok.sum(1, keepdim=True).clamp(min=1)
            gpos = np.zeros((B, G + 1, 7), np.float32)
            pair = np.zeros((B, G + 1, G + 1), np.float32)
            gvalid = np.zeros((B, G + 1), bool)
            gvisit = np.zeros((B, G + 1), bool)
            gstep = np.zeros((B, G + 1), np.int64)
            vpos = np.zeros((B, Tp + 1, 14), np.float32)
            c2g = np.zeros((B, G + 1, Tp + 1), bool)
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
            vp_img, vp_valid = F.pad(pano, (0, 0, 1, 0)), torch.cat([ones, ok], 1)
            logits = model.navigate(
                ctx, ctx_mask, gmap_img, t_(gstep), t_(gpos), t_(gvalid),
                t_(pair), t_(gvisit), vp_img, t_(vpos), vp_valid,
                torch.cat([ones, nav == 1], 1), t_(c2g))
            og = model.ground(ctx, ctx_mask, vp_img, t_(vpos), vp_valid)[:, 1 + K + V:]
            og = torch.where(ook, og, -torch.inf).cpu().numpy()
            ids = oids.cpu().numpy()
            probs = torch.softmax(logits, -1)[:, 0].cpu().numpy()
            lg = logits.cpu().numpy()
            for b in np.flatnonzero(act):
                mp = self.maps[b]
                self.ground[b][int(node[b])] = (og[b], ids[b])
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

def step_nodes(start, paths, lens, counts):
    """The node each served item stands on at each of its `counts` steps,
    decoded from its path as `duet.walk` decodes its moves."""
    out = []
    for b in range(len(start)):
        node, visited, ptr, nodes = int(start[b]), {int(start[b])}, 1, []
        for _ in range(counts[b]):
            nodes.append(node)
            rest = [int(x) for x in paths[b, ptr:lens[b]]]
            fresh = [i for i, x in enumerate(rest) if x not in visited]
            if not fresh:
                break
            ptr += fresh[0] + 1
            node = rest[fresh[0]]
            visited.add(node)
        out.append(nodes)
    return out


def census(m: dict, lt, li, lp, steps, objects):
    """(flops, attention bytes, object tokens) that episodes need: the DUET
    census with each step's `objects` (valid object tokens at the node,
    per item per step, beside `duet.walk`'s steps) in the panorama and the
    local branch, projected from their own width, and scored by the og
    head."""
    joined = [[(ov + n, nav, g) for (ov, nav, g), n in zip(item, objs)]
              for item, objs in zip(steps, objects)]
    flops, nbytes = duet.census(m, lt, li, lp, joined)
    H, Df, Do = m["hidden_size"], m["image_feat_size"], m["obj_feat_size"]
    tokens = float(sum(sum(objs) for objs in objects))
    # the DUET census embeds every panorama token from Df: objects are Do
    # wide, and the og head (Linear H -> H, Linear H -> 1) reads each
    flops += tokens * (2.0 * (Do - Df) * H + 2.0 * (H * H + H))
    return flops, nbytes, tokens
