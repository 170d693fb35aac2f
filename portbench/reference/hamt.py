"""Plain float32 HAMT-Imagine navigator (bypass imagination, cosine
alignment, 'ob_txt' action head) and the benchmark's counts of its work.

The model follows the released NavCMT (VLN-HAMT finetune_src/models/
vilmodel_cmt.py) as the configuration runs it: 9 language layers once per
episode, the bypass imagination embeddings aligned to the noun phrases by
the projection head, a history token per step from the current view, the
previous action's angle and a 2-layer encoder over the 36 views, and 4
cross-modal layers over [text; imaginations] x [history; observations].
Observations are the candidates, a STOP token and the views no candidate
claims.  Parameter names are the checkpoint's, so the same drawn weights
load into the program.

`forced_logits` replays a batch of episodes along given action slots (the
program's served actions) and returns the action logits at every step:
what the greedy policy chose from.  `census` counts the multiply-adds and
the attention bytes those episodes need, at their own lengths.
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
    x_attention,
)

PROJ = 512  # the alignment projection head's inner width


def _bert_specs(S: Specs, p: str, H: int, F_: int):
    for n in ("query", "key", "value"):
        S.linear(f"{p}.attention.self.{n}", H, H)
    S.linear(f"{p}.attention.output.dense", H, H)
    S.norm(f"{p}.attention.output.LayerNorm", H)
    S.linear(f"{p}.intermediate.dense", H, F_)
    S.linear(f"{p}.output.dense", F_, H)
    S.norm(f"{p}.output.LayerNorm", H)


def specs(m: dict) -> Specs:
    """Every parameter of the navigator at the widths of `m` (the
    configuration file's "model")."""
    H, F_, Df, A = (m["hidden_size"], m["intermediate_size"],
                    m["image_feat_size"], m["angle_feat_size"])
    S = Specs()
    S.embed("embeddings.word_embeddings", m["vocab_size"], H)
    S.embed("embeddings.position_embeddings", m["max_position_embeddings"], H)
    S.embed("embeddings.token_type_embeddings", m["type_vocab_size"], H)
    S.norm("embeddings.LayerNorm", H)
    e = "img_embeddings"
    S.linear(f"{e}.img_linear", Df, H)
    S.norm(f"{e}.img_layer_norm", H)
    S.linear(f"{e}.ang_linear", A, H)
    S.norm(f"{e}.ang_layer_norm", H)
    S.embed(f"{e}.nav_type_embedding", 3, H)
    S.norm(f"{e}.layer_norm", H)
    e = "hist_embeddings"
    S[f"{e}.cls_token"] = ((1, 1, H), "token")
    S.linear(f"{e}.img_linear", Df, H)
    S.norm(f"{e}.img_layer_norm", H)
    S.linear(f"{e}.ang_linear", A, H)
    S.norm(f"{e}.ang_layer_norm", H)
    S.embed(f"{e}.position_embeddings", m["max_action_steps"], H)
    S.embed(f"{e}.type_embedding", 1, H)
    S.norm(f"{e}.layer_norm", H)
    S.linear(f"{e}.pano_img_linear", Df, H)
    S.norm(f"{e}.pano_img_layer_norm", H)
    S.linear(f"{e}.pano_ang_linear", A, H)
    S.norm(f"{e}.pano_ang_layer_norm", H)
    for i in range(m["num_pano_layers"]):
        _bert_specs(S, f"{e}.pano_encoder.layer.{i}", H, F_)
    S.embed("imagine_embeddings.type_embedding", 1, H)
    p = "contrastive_alignment_model.image_proj"
    S.linear(f"{p}.fc1", H, PROJ, bias=False)
    S.linear(f"{p}.fc2", PROJ, PROJ, bias=False)
    S.linear(f"{p}.fc3", PROJ, H, bias=False)
    for i in range(m["num_l_layers"]):
        _bert_specs(S, f"encoder.layer.{i}", H, F_)
    for i in range(m["num_x_layers"]):
        p = f"encoder.x_layers.{i}"
        for n in ("query", "key", "value"):
            S.linear(f"{p}.visual_attention.att.{n}", H, H)
        S.linear(f"{p}.visual_attention.output.dense", H, H)
        S.norm(f"{p}.visual_attention.output.LayerNorm", H)
        for side in ("lang", "visn"):
            for n in ("query", "key", "value"):
                S.linear(f"{p}.{side}_self_att.self.{n}", H, H)
            S.linear(f"{p}.{side}_self_att.output.dense", H, H)
            S.norm(f"{p}.{side}_self_att.output.LayerNorm", H)
            S.linear(f"{p}.{side}_inter.dense", H, F_)
            S.linear(f"{p}.{side}_output.dense", F_, H)
            S.norm(f"{p}.{side}_output.LayerNorm", H)
    S.linear("next_action.net.0", H, H)
    S.norm("next_action.net.2", H)
    S.linear("next_action.net.4", H, 1)
    return S


class Hamt:
    """The navigator's modes over weights `P` at widths `m`."""

    def __init__(self, P: dict, m: dict, num: Numerics):
        self.P, self.m, self.num = P, m, num
        self.heads = m["num_attention_heads"]

    def _lin(self, name, x):
        return linear(self.P, name, x, self.num)

    def language(self, ids, mask):
        P = self.P
        L = ids.shape[1]
        x = (P["embeddings.word_embeddings.weight"][ids]
             + P["embeddings.position_embeddings.weight"][:L][None]
             + P["embeddings.token_type_embeddings.weight"][0])
        x = layer_norm(P, "embeddings.LayerNorm", x)
        ext = ext_mask(mask)
        for i in range(self.m["num_l_layers"]):
            x = bert_layer(P, f"encoder.layer.{i}", x, ext, self.heads, self.num)
        return x

    def imagine(self, feats, imagine_mask, np_weights):
        """Bypass embeddings; the rows with a noun phrase replaced by their
        projection (the alignment's in-place update)."""
        x = feats + self.P["imagine_embeddings.type_embedding.weight"][0]
        p = "contrastive_alignment_model.image_proj"
        proj = self._lin(f"{p}.fc3", F.relu(self._lin(
            f"{p}.fc2", F.relu(self._lin(f"{p}.fc1", x)))))
        valid = imagine_mask & (np_weights.sum(-1) > 0)
        return torch.where(valid[:, :, None], proj, x)

    def history_initial(self, B):
        P, e = self.P, "hist_embeddings"
        x = P[f"{e}.cls_token"][0, 0] + P[f"{e}.type_embedding.weight"][0]
        return layer_norm(P, f"{e}.layer_norm", x).expand(B, -1)

    def history_step(self, img, ang, t, pano_img, pano_ang):
        P, e = self.P, "hist_embeddings"
        x = (layer_norm(P, f"{e}.img_layer_norm", self._lin(f"{e}.img_linear", img))
             + layer_norm(P, f"{e}.ang_layer_norm", self._lin(f"{e}.ang_linear", ang))
             + P[f"{e}.position_embeddings.weight"][t]
             + P[f"{e}.type_embedding.weight"][0])
        pano = (layer_norm(P, f"{e}.pano_img_layer_norm",
                           self._lin(f"{e}.pano_img_linear", pano_img))
                + layer_norm(P, f"{e}.pano_ang_layer_norm",
                             self._lin(f"{e}.pano_ang_linear", pano_ang)))
        zero = torch.zeros((img.shape[0], 1, 1, pano.shape[1]), device=img.device)
        for i in range(self.m["num_pano_layers"]):
            pano = bert_layer(P, f"{e}.pano_encoder.layer.{i}", pano, zero,
                              self.heads, self.num)
        return layer_norm(P, f"{e}.layer_norm", x + pano.mean(1))

    def visual(self, txt, txt_mask, imag, imag_mask, hist, hist_mask, obs):
        P, e, nh, num = self.P, "img_embeddings", self.heads, self.num
        img, ang, nav, valid = obs
        ob = (layer_norm(P, f"{e}.img_layer_norm", self._lin(f"{e}.img_linear", img))
              + layer_norm(P, f"{e}.ang_layer_norm", self._lin(f"{e}.ang_linear", ang))
              + P["embeddings.token_type_embeddings.weight"][1]
              + P[f"{e}.nav_type_embedding.weight"][nav])
        ob = layer_norm(P, f"{e}.layer_norm", ob)
        Th, L = hist.shape[1], txt.shape[1]
        visn = torch.cat([hist, ob], 1)
        visn_mask = torch.cat([ext_mask(hist_mask), ext_mask(valid)], -1)
        lang = torch.cat([txt, imag], 1)
        lang_mask = torch.cat([ext_mask(txt_mask), ext_mask(imag_mask)], -1)
        for i in range(self.m["num_x_layers"]):
            p = f"encoder.x_layers.{i}"
            lang_x = x_attention(P, f"{p}.visual_attention", lang, visn,
                                 visn_mask, nh, num)
            visn_x = x_attention(P, f"{p}.visual_attention", visn, lang,
                                 lang_mask, nh, num)
            lang_s = bert_attention(P, f"{p}.lang_self_att", lang_x, lang_mask,
                                    nh, num)
            visn_s = bert_attention(P, f"{p}.visn_self_att", visn_x, visn_mask,
                                    nh, num)
            lang = ffn(P, f"{p}.lang_inter", f"{p}.lang_output", lang_s, num)
            visn = ffn(P, f"{p}.visn_inter", f"{p}.visn_output", visn_s, num)
        head = visn[:, Th:] * lang[:, :1]
        x = layer_norm(P, "next_action.net.2",
                       F.relu(self._lin("next_action.net.0", head)))
        logits = self._lin("next_action.net.4", x)[..., 0]
        return torch.where((nav != 0) & valid, logits, LOGIT_NEG)


def observe(tab, feat, scan, node, view):
    """Candidates, STOP, then the views no candidate claims."""
    cand_img, cand_ang, node_feat, pano_ang, valid, claimed = tab.see(
        feat, scan, node, view)
    B, V = scan.shape[0], tab.views
    img = torch.cat([cand_img, node_feat.new_zeros((B, 1, node_feat.shape[-1])),
                     node_feat], 1)
    ang = torch.cat([cand_ang, cand_ang.new_zeros((B, 1, 4)), pano_ang], 1)
    ones = torch.ones((B, 1), dtype=torch.bool, device=scan.device)
    nav = torch.cat([valid.long(), 2 * ones.long(),
                     torch.zeros((B, V), dtype=torch.long, device=scan.device)], 1)
    return ((img, ang, nav, torch.cat([valid, ones, ~claimed], 1)), cand_ang,
            node_feat, pano_ang)


@torch.no_grad()
def forced_logits(model: Hamt, tab, feat, ep: dict, actions: torch.Tensor):
    """ep: the episodes' tensors (scan, start_node, start_heading, txt_ids,
    txt_mask, imagine_feats, imagine_mask, np_weights) on the device;
    actions [B, T] slots (K = STOP, -1 past the item's end).  Returns the
    logits [T, B, K + 1 + V] the policy chose from at each step."""
    K = tab.K
    scan = ep["scan"].long()
    node = ep["start_node"].long()
    view = snap_view(ep["start_heading"], tab.views)
    txt = model.language(ep["txt_ids"].long(), ep["txt_mask"])
    imag = model.imagine(ep["imagine_feats"], ep["imagine_mask"],
                         ep["np_weights"])
    B, T = actions.shape
    hist = [model.history_initial(B)]
    out = []
    for t in range(T):
        obs, cand_ang, node_feat, pano_ang = observe(tab, feat, scan, node, view)
        h = torch.stack(hist, 1)
        out.append(model.visual(txt, ep["txt_mask"], imag, ep["imagine_mask"], h,
                                torch.ones(h.shape[:2], dtype=torch.bool,
                                           device=h.device), obs))
        a = actions[:, t].long()
        move = (a >= 0) & (a < K)
        slot = a.clamp(0, K - 1)
        b = torch.arange(B, device=a.device)
        prev = torch.where(move[:, None], cand_ang[b, slot], 0.0)
        hist.append(model.history_step(node_feat[b, view], prev, t, node_feat,
                                       pano_ang))
        view = torch.where(move, tab.pointid[scan, node, slot], view)
        node = torch.where(move, tab.adj[scan, node, slot], node)
    return torch.stack(out)


# ------------------------------------------------------------------ census

def bert_layer_flops(L, H, F_):
    """Multiply-adds x 2 of one post-LN BERT layer over L tokens."""
    return 2 * L * 3 * H * H + 4 * L * L * H + 2 * L * H * H + 4 * L * H * F_


def cross_flops(Lq, Lk, H):
    """One cross-attention block: q over Lq, k and v over Lk, output."""
    return 2 * Lq * H * H + 4 * Lk * H * H + 4 * Lq * Lk * H + 2 * Lq * H * H


def attn_bytes(Lq, Lk, H, elt=2):
    """One attention call: q and out over Lq, k and v over Lk, in the
    compute dtype, and the f32 key mask, each read or written once."""
    return (2 * Lq + 2 * Lk) * H * elt + 4 * Lk


def obs_counts(tab):
    """Per (scan, node): observation tokens the policy reads (valid
    candidates, STOP, unclaimed views) and the navigable ones."""
    valid, pointid = tab.valid.cpu().numpy(), tab.pointid.cpu().numpy()
    V = tab.views
    claimed = np.zeros(valid.shape[:2] + (V,), bool)
    s, n, k = np.nonzero(valid)
    claimed[s, n, pointid[s, n, k]] = True
    nv = valid.sum(-1)
    return nv + 1 + V - claimed.sum(-1), nv + 1


def census(m: dict, V: int, lt, li, lp, tokens, obs_tok, nav_tok):
    """(flops, attention bytes) that episodes need: per item its text
    length `lt`, imaginations `li` (of them `lp` with a noun phrase), its
    steps `tokens`, and per step [B, T] its observation and navigable
    token counts (entries past an item's steps are ignored)."""
    H, F_, Df, A = (m["hidden_size"], m["intermediate_size"],
                    m["image_feat_size"], m["angle_feat_size"])
    nl, nx, npn = m["num_l_layers"], m["num_x_layers"], m["num_pano_layers"]
    lt, li, lp, tokens = (np.asarray(a, np.float64) for a in (lt, li, lp, tokens))
    T = obs_tok.shape[1]
    t = np.arange(T, dtype=np.float64)[None, :]
    act = t < tokens[:, None]
    Ll = (lt + li)[:, None]
    Lv = t + 1 + obs_tok
    step_f = (2 * obs_tok * (Df + A) * H
              + nx * (cross_flops(Ll, Lv, H) + cross_flops(Lv, Ll, H)
                      + bert_layer_flops(Ll, H, F_) + bert_layer_flops(Lv, H, F_))
              + 2 * nav_tok * (H * H + H))
    step_b = nx * (attn_bytes(Ll, Lv, H) + attn_bytes(Lv, Ll, H)
                   + attn_bytes(Ll, Ll, H) + attn_bytes(Lv, Lv, H))
    # a history token is needed where a later step reads it
    hist = np.clip(tokens - 1, 0, None)
    hist_f = (2 * (Df + A) * H * (1 + V)
              + npn * bert_layer_flops(V, H, F_))
    flops = (np.sum(np.where(act, step_f, 0.0))
             + np.sum(hist) * hist_f
             + np.sum(nl * bert_layer_flops(lt, H, F_))
             + np.sum(lp * 2 * (H * PROJ + PROJ * PROJ + PROJ * H) + 2 * lp * lt * H))
    nbytes = (np.sum(np.where(act, step_b, 0.0))
              + np.sum(hist) * npn * attn_bytes(V, V, H)
              + np.sum(nl * attn_bytes(lt, lt, H)))
    return float(flops), float(nbytes)
