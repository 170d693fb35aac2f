"""DUET-Imagine: dual-scale global topological map + local panorama graph
transformer, in PyTorch.

The port of `vln_imagine_tpu/models/duet.py` (itself a rebuild of
GlocalTextPathNavCMT, VLN-DUET/map_nav_src/models/vilmodel.py:1022-1289, and
its VLNBert wrapper, models/model.py:12-62).  Each reference mode is a
method:

- text       (forward_text :1075)
- imagine    (forward_imagination :1081, bypass)
- align_with_contrastive_loss (AlignWithContrastiveLoss :591-655), with the
  text detached under `fix_lang_inside_cosine_model` (:1249)
- panorama_per_step (:1087-1131): img + loc + nav-type + token-type
  embeddings -> the pre-norm pano encoder
- navigation_per_step (:1133-1235): the global branch (step and position
  embeddings, graph-sprel-biased cross-modal encoder), the local branch
  ([stop] + pano tokens with 14-d viewpoint position features), dynamic
  sigmoid fusion and the fused-logit graph merge; with objects (REVERIE /
  SOON) the `og_head` grounding logits over the local branch's object
  tokens (:1221-1225)

Module names are the reference's torch keys (`lang_encoder.layer.*`,
`img_embeddings.pano_encoder.layers.*`, `global_encoder.sprel_linear`, ...),
so a released state_dict loads with `load_state_dict`.  Every mode takes
`rng` (ops/dropout.py); without it dropout is off.

Object tokens reach the pano encoder through the view embedding:
`observe_duet` pads or truncates their features to the view dim.  So
`img_embeddings.obj_linear` / `obj_layer_norm`, which the model holds when
`obj_feat_size != image_feat_size` as the JAX package does, are never
applied (they keep a released checkpoint's keys).

Under `e2e_imagination` the imagine mode embeds raw imagination images
with the in-model ViT (`imagine_vit`, models/vit.py), as HAMT's does.

`CrossmodalEncoder.lang2visn_stack` is pre-training's direction (the
language queries a branch, pretrain vilmodel.py:724-745); only
`pretrain/duet_model.py` builds its language-side blocks, as only the JAX
package's pre-training model reaches them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from vln_imagine_tpu_torch.config import ModelConfig
from vln_imagine_tpu_torch.models.bert import (
    BertEmbeddings,
    BertEncoder,
    ClsPrediction,
    Dense,
    Embed,
    GraphLXRTXLayer,
    LayerNorm12,
    PreNormEncoder,
    compute_dtype,
)
from vln_imagine_tpu_torch.models.hamt import (
    BypassImagineEmbeddings,
    ContrastiveAlignment,
    _stop_gradient,
    align_imagination,
)
from vln_imagine_tpu_torch.models.vit import (
    extract_imagine_features,
    make_imagine_vit,
)
from vln_imagine_tpu_torch.ops.dropout import dropout
from vln_imagine_tpu_torch.ops.masks import extend_neg_mask, mask_logits


class CrossmodalEncoder(nn.Module):
    """num_x_layers GraphLXRTXLayers (vilmodel.py:436-453); `lang` /
    `visn` choose the layers' blocks (GraphLXRTXLayer)."""

    def __init__(self, cfg: ModelConfig, lang: bool = False,
                 visn: bool = True):
        super().__init__()
        self.x_layers = nn.ModuleList(GraphLXRTXLayer(cfg, lang, visn)
                                      for _ in range(cfg.num_x_layers))

    def forward(self, txt_embeds, txt_mask, img_embeds, img_mask,
                graph_sprels=None, rng=None):
        ext_txt, ext_img = extend_neg_mask(txt_mask), extend_neg_mask(img_mask)
        for layer in self.x_layers:
            img_embeds = layer(txt_embeds, ext_txt, img_embeds, ext_img,
                               graph_sprels, rng)
        return img_embeds

    def lang2visn_stack(self, txt_embeds, txt_mask, img_embeds, img_mask,
                        rng=None):
        """The language stream queried through every layer against a fixed
        visual stream (pretrain vilmodel.py:724-745)."""
        ext_txt, ext_img = extend_neg_mask(txt_mask), extend_neg_mask(img_mask)
        for layer in self.x_layers:
            txt_embeds = layer.lang2visn(txt_embeds, ext_txt, img_embeds,
                                         ext_img, rng)
        return txt_embeds


def _pos_embeddings(in_features: int, cfg: ModelConfig) -> nn.ModuleDict:
    """Linear -> LayerNorm, the reference's nn.Sequential `.0` / `.1`."""
    return nn.ModuleDict({"0": Dense(in_features, cfg.hidden_size,
                                     compute_dtype(cfg)),
                          "1": LayerNorm12(cfg.hidden_size)})


class ImageEmbeddings(nn.Module):
    """View-feature embeddings + the pano encoder (vilmodel.py:455-526);
    `objects=False` leaves out the object projection (pre-training has
    none)."""

    def __init__(self, cfg: ModelConfig, objects: bool = True):
        super().__init__()
        H, dt = cfg.hidden_size, compute_dtype(cfg)
        self.img_linear = Dense(cfg.image_feat_size, H, dt)
        self.img_layer_norm = LayerNorm12(H)
        self.loc_linear = Dense(cfg.angle_feat_size + 3, H, dt)
        self.loc_layer_norm = LayerNorm12(H)
        self.nav_type_embedding = Embed(3, H, dt)
        self.layer_norm = LayerNorm12(H)
        self.pano_encoder = PreNormEncoder(cfg, cfg.num_pano_layers)
        if objects and 0 < cfg.obj_feat_size != cfg.image_feat_size:
            # created and never applied, as in the JAX package
            self.obj_linear = Dense(cfg.obj_feat_size, H, dt)
            self.obj_layer_norm = LayerNorm12(H)


class LocalEncoder(nn.Module):
    """The local (viewpoint) branch (vilmodel.py:528-560)."""

    def __init__(self, cfg: ModelConfig, lang: bool = False,
                 visn: bool = True):
        super().__init__()
        self.vp_pos_embeddings = _pos_embeddings(2 * (cfg.angle_feat_size + 3),
                                                 cfg)
        self.encoder = CrossmodalEncoder(cfg, lang, visn)


class GlobalEncoder(nn.Module):
    """The global (topological map) branch (vilmodel.py:923-1006).  The
    graph-bias projection biases the visual side's self-attention, so it
    comes with that side."""

    def __init__(self, cfg: ModelConfig, lang: bool = False,
                 visn: bool = True):
        super().__init__()
        dt = compute_dtype(cfg)
        self.gmap_pos_embeddings = _pos_embeddings(cfg.angle_feat_size + 3, cfg)
        self.gmap_step_embeddings = Embed(cfg.max_action_steps,
                                          cfg.hidden_size, dt)
        if cfg.graph_sprels and visn:
            self.sprel_linear = Dense(1, 1, dt)
        self.encoder = CrossmodalEncoder(cfg, lang, visn)


class NavOut(NamedTuple):
    global_logits: torch.Tensor  # [B, G+1] (slot 0 = stop)
    local_logits: torch.Tensor   # [B, T_pano+1] (slot 0 = stop)
    fused_logits: torch.Tensor   # [B, G+1]
    gmap_embeds: torch.Tensor
    vp_embeds: torch.Tensor
    obj_logits: torch.Tensor | None = None  # [B, T_pano+1] REVERIE/SOON


class DuetModel(nn.Module):
    """GlocalTextPathNavCMT + the VLNBert wrapper's env-feature dropout."""

    def __init__(self, cfg: ModelConfig, feat_dropout: float = 0.4):
        super().__init__()
        if cfg.imagine_enc_pano and not cfg.bypass_imag_encoder:
            # the DUET reference ships only the bypass embeddings
            # (vilmodel.py:562), and so does the JAX package
            raise ValueError(
                "DuetModel supports bypass_imag_encoder=True only (the "
                "non-bypass pano imagination encoder exists in the HAMT "
                "stack alone)")
        self.config = cfg
        self.feat_dropout = feat_dropout
        self.embeddings = BertEmbeddings(cfg)
        self.lang_encoder = BertEncoder(cfg, cfg.num_l_layers)
        self.img_embeddings = ImageEmbeddings(cfg)
        self.local_encoder = LocalEncoder(cfg)
        self.global_encoder = GlobalEncoder(cfg)
        self.global_sap_head = ClsPrediction(cfg)
        self.local_sap_head = ClsPrediction(cfg)
        if cfg.glocal_fuse:
            self.sap_fuse_linear = ClsPrediction(cfg,
                                                 input_size=2 * cfg.hidden_size)
        if cfg.obj_feat_size > 0:
            self.og_head = ClsPrediction(cfg)
        if cfg.imagine_enc_pano:
            self.imagine_embeddings = BypassImagineEmbeddings(cfg)
            if cfg.use_cosine_aux_loss or cfg.no_loss_test:
                self.contrastive_alignment_model = ContrastiveAlignment(cfg)
            if cfg.e2e_imagination != "off":
                self.imagine_vit = make_imagine_vit(cfg)

    def drop_env(self, feats, rng):
        """The VLNBert wrapper's env-feature dropout (models/model.py)."""
        return dropout(feats, self.feat_dropout, rng)

    # ------------------------------------------------------------------ modes
    def text(self, txt_ids, txt_mask, rng=None):
        cfg = self.config
        with _stop_gradient(cfg.fix_lang_embedding or cfg.fix_local_branch
                            or not cfg.update_lang_bert):
            return self.lang_encoder(self.embeddings(txt_ids, rng),
                                     extend_neg_mask(txt_mask), rng)

    def imagine(self, imagine_feats, rng=None):
        """imagine_feats: [B, I, H] features, or under e2e_imagination raw
        images [B, I, Hp, Wp, 3] for the in-model ViT."""
        if self.config.e2e_imagination != "off":
            imagine_feats = extract_imagine_features(
                self.imagine_vit, imagine_feats, self.config)
        return self.imagine_embeddings(self.drop_env(imagine_feats, rng))

    def align_with_contrastive_loss(self, txt_embeds, txt_mask, imagine_embeds,
                                    imagine_mask, np_weights, rng=None):
        """The HAMT alignment, with the DUET option of detaching the text
        stream (vilmodel.py:1249-1255)."""
        if self.config.fix_lang_inside_cosine_model:
            txt_embeds = txt_embeds.detach()
        return align_imagination(self.contrastive_alignment_model.image_proj,
                                 self.config, txt_embeds, imagine_embeds,
                                 imagine_mask, np_weights, rng)

    def panorama_per_step(self, view_img_fts, loc_fts, nav_types, valid,
                          rng=None):
        """[B, T_pano, Df] view features (+ [B, T_pano, A+3] loc features)
        -> pano token embeddings (vilmodel.py:1087-1131)."""
        cfg, emb = self.config, self.img_embeddings
        with _stop_gradient(cfg.fix_pano_embedding or cfg.fix_local_branch):
            x = emb.img_layer_norm(emb.img_linear(
                self.drop_env(view_img_fts, rng)))
            type_ids = torch.ones((1, 1), dtype=torch.long,
                                  device=nav_types.device)
            x = (x + emb.loc_layer_norm(emb.loc_linear(loc_fts))
                 + emb.nav_type_embedding(nav_types)
                 + self.embeddings.token_type_embeddings(type_ids))
            x = dropout(emb.layer_norm(x), cfg.hidden_dropout_prob, rng)
            return emb.pano_encoder(x, key_padding_mask=valid, rng=rng)

    def navigation_per_step(
        self, txt_embeds, txt_mask,
        gmap_img_embeds, gmap_step_ids, gmap_pos_fts, gmap_valid,
        gmap_pair_dists, gmap_visited,
        vp_img_embeds, vp_pos_fts, vp_valid, vp_nav_valid,
        cand_to_gmap,       # [B, G+1, T_pano+1] bool: gmap slot g is vp token j
        imagine_embeds=None, imagine_mask=None, vp_obj_valid=None, rng=None,
    ) -> NavOut:
        cfg, glob, loc = self.config, self.global_encoder, self.local_encoder

        # global branch inputs (vilmodel.py:1141-1149)
        gmap_embeds = (gmap_img_embeds
                       + glob.gmap_step_embeddings(gmap_step_ids)
                       + glob.gmap_pos_embeddings["1"](
                           glob.gmap_pos_embeddings["0"](gmap_pos_fts)))
        graph_sprels = None
        if cfg.graph_sprels:
            # [B, 1, G+1, G+1] in the compute dtype, added to the f32 mask
            graph_sprels = glob.sprel_linear(
                gmap_pair_dists[..., None])[..., 0][:, None]

        # local branch inputs (vilmodel.py:1152)
        vp_embeds = vp_img_embeds + loc.vp_pos_embeddings["1"](
            loc.vp_pos_embeddings["0"](vp_pos_fts))

        # cross-modal context [txt; imagine] (vilmodel.py:1154-1166)
        ctx, ctx_mask = txt_embeds, txt_mask
        if cfg.imagine_enc_pano and cfg.concat_imagine_with == "language":
            ctx = torch.cat([txt_embeds, imagine_embeds], dim=1)
            ctx_mask = torch.cat([txt_mask, imagine_mask], dim=1)

        gmap_embeds = glob.encoder(ctx, ctx_mask, gmap_embeds, gmap_valid,
                                   graph_sprels, rng)
        vp_embeds = loc.encoder(ctx, ctx_mask, vp_embeds, vp_valid, None, rng)

        # fusion weights (vilmodel.py:1182-1197): only 'dynamic' learns them
        if cfg.glocal_fuse and cfg.fusion == "dynamic":
            fuse = torch.sigmoid(self.sap_fuse_linear(
                torch.cat([gmap_embeds[:, 0], vp_embeds[:, 0]], dim=-1)))
        else:
            fuse = torch.full((gmap_embeds.shape[0], 1), 0.5,
                              dtype=gmap_embeds.dtype, device=gmap_embeds.device)

        global_logits = self.global_sap_head(gmap_embeds)[..., 0] * fuse
        global_logits = mask_logits(global_logits, ~gmap_visited & gmap_valid)
        local_logits = self.local_sap_head(vp_embeds)[..., 0] * (1 - fuse)
        local_logits = mask_logits(local_logits, vp_nav_valid)
        fused = fused_logit_merge(global_logits, local_logits, gmap_visited,
                                  gmap_valid, vp_nav_valid, cand_to_gmap)
        # object grounding logits (REVERIE/SOON; vilmodel.py:1221-1225)
        obj_logits = None
        if cfg.obj_feat_size > 0 and vp_obj_valid is not None:
            obj_logits = mask_logits(self.og_head(vp_embeds)[..., 0],
                                     vp_obj_valid)
        return NavOut(global_logits=global_logits, local_logits=local_logits,
                      fused_logits=fused, gmap_embeds=gmap_embeds,
                      vp_embeds=vp_embeds, obj_logits=obj_logits)


def fused_logit_merge(global_logits, local_logits, gmap_visited, gmap_valid,
                      vp_nav_valid, cand_to_gmap):
    """Graph-aware fusion of local candidate logits into global node logits,
    the array form of the python loop at vilmodel.py:1200-1217.

    cand_to_gmap[b, g, j]: gmap slot g (g>0) is the viewpoint of local token
    j (j>0; j=0 is stop).  A candidate on a *visited* gmap node adds to the
    shared backtrack logit bw; each unvisited gmap node adds its matching
    candidate's logit, or bw if no candidate reaches it directly."""
    fused = global_logits.clone()
    fused[:, 0] = fused[:, 0] + local_logits[:, 0]

    j_valid = vp_nav_valid.clone()
    j_valid[:, 0] = False                              # candidate tokens only
    local_val = torch.where(j_valid, local_logits, 0.0)
    c2g = cand_to_gmap.float()

    seen = (gmap_visited & gmap_valid).float()
    cand_hits_visited = torch.einsum("bgj,bg->bj", c2g, seen) > 0
    bw = torch.sum(torch.where(cand_hits_visited & j_valid, local_val, 0.0),
                   dim=1)

    cand_unvisited = j_valid & ~cand_hits_visited
    contrib = torch.einsum("bgj,bj->bg", c2g,
                           torch.where(cand_unvisited, local_val, 0.0).float())
    has_match = torch.einsum("bgj,bj->bg", c2g, cand_unvisited.float()) > 0

    g_unvisited = gmap_valid & ~gmap_visited
    g_unvisited[:, 0] = False
    add = torch.where(has_match, contrib, bw[:, None].float()) * g_unvisited
    return fused + add.to(fused.dtype)
