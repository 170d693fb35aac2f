"""HAMT-Imagine: history-aware cross-modal transformer, in PyTorch.

The port of `vln_imagine_tpu/models/hamt.py` (itself a rebuild of NavCMT,
VLN-HAMT/finetune_src/models/vilmodel_cmt.py:966-1205, and its VLNBertCMT
wrapper, models/model_HAMT.py:13-97).  Each reference mode is a method:

- language  (vilmodel_cmt.py:1008-1030)
- history_initial / history_step (:1033-1038 + HistoryEmbeddings :546-618)
- imagine   (the bypass variant :620-631 of the released configs, or the
  full imagination encoder :634-703 under bypass_imag_encoder=False)
- align_with_contrastive_loss (:1050-1053 / AlignWithContrastiveLoss
  :730-790) as one masked segment-mean matmul, with the cosine, InfoNCE or
  margin loss (:777-856)
- visual    (:1056-1205), cross-modal streams [txt; imagine] x [hist; obs];
  under no_lang_ca the text is not updated by the cross-modal layers and
  the language mode returns one static text per layer (:1022-1029)
- with `obj_feat_size` > 0, the REVERIE object segment of NavRefCMT
  (finetune_src/reverie/vlnbert_navref.py:11-155): `obj_embeddings`, the
  visual stream [hist; obs; obj] and the `ref_object` grounding head; its
  language mode returns the final text for every layer (:66-80) and its
  action head is next_action(ob * hist[CLS]) under no_lang_ca (:150)

Every mode takes `rng` (ops/dropout.py): with it the flax blocks' dropouts
and the wrapper's env-feature dropout (`drop_env`, `feat_dropout`) are
active, without it they are the identity.  The released recipe's stop-
gradients (`fix_lang_embedding`, `fix_hist_embedding`, and
`fix_imagine_embeds` / `fix_obs_embedding`) run their branch under
`torch.no_grad()`, so no residuals are kept for layers that get no gradient.

Under `e2e_imagination` ('frozen' or 'trainable') the imagine mode takes
raw imagination images [B, I, Hp, Wp, 3] and embeds them with the in-model
ViT (`imagine_vit`, models/vit.py) before the imagination embeddings;
'frozen' runs the ViT without autograd.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch import nn

from vln_imagine_tpu_torch.config import ModelConfig
from vln_imagine_tpu_torch.models.bert import (
    BertEmbeddings,
    BertEncoder,
    BertLayer,
    Dense,
    Embed,
    LayerNorm12,
    LXRTXLayer,
    MLPProjectionHead,
    NextActionPrediction,
    compute_dtype,
)
from vln_imagine_tpu_torch.models.vit import (
    extract_imagine_features,
    make_imagine_vit,
)
from vln_imagine_tpu_torch.ops.dropout import dropout
from vln_imagine_tpu_torch.ops.masks import extend_neg_mask, mask_logits


def _stop_gradient(fixed: bool):
    """The context of a branch whose output the JAX package wraps in
    `stop_gradient`: no autograd inside it."""
    return torch.no_grad() if fixed else contextlib.nullcontext()


class ImageEmbeddings(nn.Module):
    """img/angle linear+LN + nav-type + token-type -> LN -> dropout
    (vilmodel_cmt.py:521-544)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        H, dt = cfg.hidden_size, compute_dtype(cfg)
        self.img_linear = Dense(cfg.image_feat_size, H, dt)
        self.img_layer_norm = LayerNorm12(H)
        self.ang_linear = Dense(cfg.angle_feat_size, H, dt)
        self.ang_layer_norm = LayerNorm12(H)
        self.nav_type_embedding = Embed(3, H, dt)
        self.layer_norm = LayerNorm12(H)
        self.rate = cfg.hidden_dropout_prob

    def forward(self, img_feat, ang_feat, type_embeddings, nav_types, rng=None):
        x = (self.img_layer_norm(self.img_linear(img_feat))
             + self.ang_layer_norm(self.ang_linear(ang_feat))
             + type_embeddings
             + self.nav_type_embedding(nav_types))
        return dropout(self.layer_norm(x), self.rate, rng)


class ObjectEmbeddings(nn.Module):
    """REVERIE object tokens (NavRefCMT ObjectEmbeddings,
    vlnbert_navref.py:11-41): img/ang/5-d-bbox-pos linear+LN branches plus
    the image module's nav-type embedding (type 2) and the token-type
    embedding, final LN -> dropout."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        H, dt = cfg.hidden_size, compute_dtype(cfg)
        self.img_linear = Dense(cfg.obj_feat_size, H, dt)
        self.img_layer_norm = LayerNorm12(H)
        self.ang_linear = Dense(cfg.angle_feat_size, H, dt)
        self.ang_layer_norm = LayerNorm12(H)
        self.pos_linear = Dense(5, H, dt)
        self.pos_layer_norm = LayerNorm12(H)
        self.layer_norm = LayerNorm12(H)
        self.rate = cfg.hidden_dropout_prob

    def forward(self, obj_feat, obj_ang, obj_pos, type_embeddings,
                nav_type_embeddings, rng=None):
        x = (self.img_layer_norm(self.img_linear(obj_feat))
             + self.ang_layer_norm(self.ang_linear(obj_ang))
             + self.pos_layer_norm(self.pos_linear(obj_pos))
             + nav_type_embeddings + type_embeddings)
        return dropout(self.layer_norm(x), self.rate, rng)


class HistoryEmbeddings(nn.Module):
    """Per-step history token (vilmodel_cmt.py:546-618): current-view +
    prev-action-angle linears + step position + type embedding, plus a
    pano sub-encoder mean-pooled over the views."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        H, dt = cfg.hidden_size, compute_dtype(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, H))
        self.img_linear = Dense(cfg.image_feat_size, H, dt)
        self.img_layer_norm = LayerNorm12(H)
        self.ang_linear = Dense(cfg.angle_feat_size, H, dt)
        self.ang_layer_norm = LayerNorm12(H)
        self.position_embeddings = Embed(cfg.max_action_steps, H, dt)
        self.type_embedding = Embed(1, H, dt)
        self.layer_norm = LayerNorm12(H)
        self.pano_img_linear = Dense(cfg.image_feat_size, H, dt)
        self.pano_img_layer_norm = LayerNorm12(H)
        self.pano_ang_linear = Dense(cfg.angle_feat_size, H, dt)
        self.pano_ang_layer_norm = LayerNorm12(H)
        self.pano_encoder = BertEncoder(cfg, cfg.num_pano_layers)
        self.rate = cfg.hidden_dropout_prob

    def _type(self, batch_size: int) -> torch.Tensor:
        ids = torch.zeros((batch_size,), dtype=torch.long,
                          device=self.cls_token.device)
        return self.type_embedding(ids)

    def initial(self, batch_size: int, rng=None) -> torch.Tensor:
        """The [CLS]-style step-0 global history token (:592-595)."""
        x = self.cls_token[0, 0][None, :] + self._type(batch_size)
        return dropout(self.layer_norm(x), self.rate, rng)

    def forward(self, img_feats, ang_feats, step_ids, pano_img_feats,
                pano_ang_feats, rng=None):
        B = img_feats.shape[0]
        x = (self.img_layer_norm(self.img_linear(img_feats))
             + self.ang_layer_norm(self.ang_linear(ang_feats))
             + self.position_embeddings(step_ids)
             + self._type(B))
        pano = (self.pano_img_layer_norm(self.pano_img_linear(pano_img_feats))
                + self.pano_ang_layer_norm(self.pano_ang_linear(pano_ang_feats)))
        pano = dropout(pano, self.rate, rng)
        zero_mask = torch.zeros((B, 1, 1, pano.shape[1]), dtype=torch.float32,
                                device=pano.device)
        pano = self.pano_encoder(pano, zero_mask, rng)
        return dropout(self.layer_norm(x + pano.mean(dim=1)), self.rate, rng)


class BypassImagineEmbeddings(nn.Module):
    """features + type embedding (vilmodel_cmt.py:620-631); the path of all
    released configs (--bypass_imag_encoder)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.type_embedding = Embed(1, cfg.hidden_size, compute_dtype(cfg))

    def forward(self, imagine_feat):
        ids = torch.zeros((imagine_feat.shape[0], 1), dtype=torch.long,
                          device=imagine_feat.device)
        return imagine_feat + self.type_embedding(ids)


class ImagineEmbeddings(nn.Module):
    """The full imagination encoder (vilmodel_cmt.py:634-703): features +
    position + type embedding, linear + LN, dropout, a `num_pano_layers`
    BERT encoder over the imagination tokens with their padding mask, LN,
    dropout.  An item without imaginations has every key masked."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        H, dt = cfg.hidden_size, compute_dtype(cfg)
        self.position_embeddings = Embed(cfg.max_imagination_len, H, dt)
        self.type_embedding = Embed(1, H, dt)
        self.pano_img_linear = Dense(H, H, dt)
        self.pano_img_layer_norm = LayerNorm12(H)
        self.pano_encoder = BertEncoder(cfg, cfg.num_pano_layers)
        self.layer_norm = LayerNorm12(H)
        self.rate = cfg.hidden_dropout_prob

    def forward(self, feats, imagine_mask, rng=None):
        B, I, _ = feats.shape
        ids = torch.arange(I, device=feats.device)[None, :].expand(B, I)
        x = (feats + self.position_embeddings(ids)
             + self.type_embedding(torch.zeros_like(ids)))
        x = dropout(self.pano_img_layer_norm(self.pano_img_linear(x)),
                    self.rate, rng)
        x = self.pano_encoder(x, extend_neg_mask(imagine_mask), rng)
        return dropout(self.layer_norm(x), self.rate, rng)


class ContrastiveAlignment(nn.Module):
    """Holds the projection head under the reference's key names
    (`contrastive_alignment_model.image_proj.*`)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.image_proj = MLPProjectionHead(cfg)


def contrastive_alignment_loss(proj, mean_np, valid, aux_loss_type="cosine",
                               temperature=0.3, margin=1.0, groups=None):
    """Imagination-text alignment losses over [B, I, H] projections:

    - 'cosine': mean over valid rows of 1 - cos(proj, mean_np)
      (AlignWithContrastiveLoss, vilmodel_cmt.py:777-788)
    - 'infonce': CE of the positive against the other batch items' valid
      noun-phrase means at `temperature` (:793-823), as a logsumexp over the
      negatives that are there (masked ones drop out, so an item without
      negatives has loss 0 and a finite gradient)
    - 'margin': 1 - cos + the mean hinge(margin + neg_sim - pos_sim)
      (:825-856)

    groups: optional [B] labels 0 / 1 of a fused batch (the IL and RL halves
    of one train step).  The loss is then the SUM of each group's separately
    normalised mean, and negatives come only from the same group: what two
    separate rollouts give (agent_cmt.py:437-462)."""
    B, I, _ = proj.shape

    def unit(x):
        x = x.float()
        return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                               min=1e-8)

    pn, mn = unit(proj), unit(mean_np)
    pos_sim = torch.sum(pn * mn, dim=-1)                      # [B, I]

    def grouped_mean(per_row):                                # [B, I] -> ()
        if groups is None:
            v = valid.float()
            return torch.sum(per_row * v) / torch.clamp(torch.sum(v), min=1.0)
        total = torch.zeros((), device=per_row.device)
        for g in (0, 1):
            in_g = (groups == g)[:, None] & valid
            total = total + (torch.sum(torch.where(in_g, per_row, 0.0))
                             / torch.clamp(torch.sum(in_g), min=1))
        return total

    if aux_loss_type == "cosine":
        return grouped_mean(1.0 - pos_sim)
    if aux_loss_type not in ("infonce", "margin"):
        raise ValueError(aux_loss_type)
    sim = torch.einsum("bih,cjh->bicj", pn, mn)               # [B, I, B, I]
    items = torch.arange(B, device=proj.device)
    other = items[:, None] != items[None, :]                  # [B, C]
    if groups is not None:
        other = other & (groups[:, None] == groups[None, :])
    neg_mask = (other[:, None, :, None] & valid[None, None, :, :]
                ).expand(sim.shape)
    if aux_loss_type == "infonce":
        logits_pos = pos_sim / temperature
        logits_neg = torch.where(neg_mask, sim / temperature, -torch.inf)
        all_logits = torch.cat([logits_pos[..., None],
                                logits_neg.reshape(B, I, -1)], dim=-1)
        return grouped_mean(torch.logsumexp(all_logits, dim=-1) - logits_pos)
    hinge = torch.clamp(margin + sim - pos_sim[:, :, None, None], min=0.0)
    n_neg = torch.clamp(torch.sum(neg_mask, dim=(2, 3)), min=1)
    neg_loss = torch.sum(torch.where(neg_mask, hinge, 0.0), dim=(2, 3)) / n_neg
    return grouped_mean((1.0 - pos_sim) + neg_loss)


def align_imagination(image_proj, cfg: ModelConfig, txt_embeds, imagine_embeds,
                      imagine_mask, np_weights, rng=None, groups=None):
    """Alignment of projected imagination embeddings to the mean noun-phrase
    token embedding of their sub-instruction.  Returns (loss, new_imagine):
    valid rows are overwritten with their projection, the reference's
    in-place update (vilmodel_cmt.py:781)."""
    proj = image_proj(imagine_embeds, rng)
    mean_np = torch.einsum("bil,blh->bih", np_weights.to(txt_embeds.dtype),
                           txt_embeds)
    valid = imagine_mask & (torch.sum(np_weights, dim=-1) > 0)
    loss = contrastive_alignment_loss(
        proj, mean_np, valid, cfg.aux_loss_type, cfg.infonce_temperature,
        cfg.contrastive_margin_value, groups)
    new_imagine = torch.where(valid[:, :, None], proj, imagine_embeds)
    return loss, new_imagine


class VisualOut(NamedTuple):
    act_logits: torch.Tensor   # [B, T_obs]
    txt_embeds: torch.Tensor   # [B, L, H]
    hist_embeds: torch.Tensor  # [B, T, H]
    ob_embeds: torch.Tensor    # [B, T_obs, H]
    state: torch.Tensor        # [B, H] critic state
    obj_logits: torch.Tensor | None = None  # [B, Ko] REVERIE grounding


class HamtEncoder(nn.Module):
    """Container for the reference's `encoder.layer.*` / `encoder.x_layers.*`
    keys."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_l_layers))
        self.x_layers = nn.ModuleList(
            LXRTXLayer(cfg) for _ in range(cfg.num_x_layers))


class HamtModel(nn.Module):
    """NavCMT + the VLNBertCMT wrapper's env-feature dropout, one module."""

    def __init__(self, cfg: ModelConfig, feat_dropout: float = 0.4):
        super().__init__()
        self.config = cfg
        self.feat_dropout = feat_dropout
        self.embeddings = BertEmbeddings(cfg)
        self.img_embeddings = ImageEmbeddings(cfg)
        self.hist_embeddings = HistoryEmbeddings(cfg)
        if cfg.imagine_enc_pano:
            self.imagine_embeddings = (BypassImagineEmbeddings(cfg)
                                       if cfg.bypass_imag_encoder
                                       else ImagineEmbeddings(cfg))
            if cfg.use_cosine_aux_loss or cfg.no_loss_test:
                self.contrastive_alignment_model = ContrastiveAlignment(cfg)
            if cfg.e2e_imagination != "off":
                self.imagine_vit = make_imagine_vit(cfg)
        self.encoder = HamtEncoder(cfg)
        self.next_action = NextActionPrediction(cfg)
        if cfg.obj_feat_size > 0:
            # REVERIE object segment (NavRefCMT: ObjectEmbeddings
            # vlnbert_navref.py:11-41 + ref_object head :56,153)
            self.obj_embeddings = ObjectEmbeddings(cfg)
            self.ref_object = NextActionPrediction(cfg)

    def drop_env(self, feats, rng):
        """The VLNBertCMT wrapper's env-feature dropout (models/model_HAMT.py)."""
        return dropout(feats, self.feat_dropout, rng)

    # ------------------------------------------------------------------ modes
    def language(self, txt_ids, txt_mask, rng=None):
        """The text embeddings [B, L, H]; under no_lang_ca the stack
        [1 + X, B, L, H] of the base text and each x-layer's language
        self-attention branch over the BASE text (vilmodel_cmt.py:1022-1029:
        the reference does not chain them).  NavRefCMT (objects + no_lang_ca,
        vlnbert_navref.py:66-80,143) returns the final text in every slot."""
        ext = extend_neg_mask(txt_mask)
        with _stop_gradient(self.config.fix_lang_embedding):
            x = self.embeddings(txt_ids, rng)
            for layer in self.encoder.layer:
                x = layer(x, ext, rng)
        if not self.config.no_lang_ca:
            return x
        if self.config.obj_feat_size > 0:
            return x[None].expand(1 + len(self.encoder.x_layers), *x.shape)
        return torch.stack([x] + [layer.lang_self_att_branch(x, ext, rng)
                                  for layer in self.encoder.x_layers])

    def history_initial(self, batch_size: int, rng=None):
        with _stop_gradient(self.config.fix_hist_embedding):
            return self.hist_embeddings.initial(batch_size, rng)

    def history_step(self, hist_img_feats, prev_act_angle, step_id: int,
                     pano_img_feats, pano_ang_feats, rng=None):
        """One new history token for time `step_id` (agent_cmt.py:596-605)."""
        with _stop_gradient(self.config.fix_hist_embedding):
            hist_img_feats = self.drop_env(hist_img_feats, rng)
            pano_img_feats = self.drop_env(pano_img_feats, rng)
            B = hist_img_feats.shape[0]
            step_ids = torch.full((B,), step_id, dtype=torch.long,
                                  device=hist_img_feats.device)
            return self.hist_embeddings(hist_img_feats, prev_act_angle,
                                        step_ids, pano_img_feats,
                                        pano_ang_feats, rng)

    def imagine(self, imagine_feats, imagine_mask=None, rng=None):
        """imagine_feats: [B, I, H] features, or under e2e_imagination raw
        images [B, I, Hp, Wp, 3] for the in-model ViT."""
        with _stop_gradient(self.config.fix_imagine_embeds):
            if self.config.e2e_imagination != "off":
                imagine_feats = extract_imagine_features(
                    self.imagine_vit, imagine_feats, self.config)
            feats = self.drop_env(imagine_feats, rng)
            if self.config.bypass_imag_encoder:
                return self.imagine_embeddings(feats)
            return self.imagine_embeddings(feats, imagine_mask, rng)

    def align_with_contrastive_loss(self, txt_embeds, txt_mask, imagine_embeds,
                                    imagine_mask, np_weights, rng=None,
                                    groups=None):
        return align_imagination(self.contrastive_alignment_model.image_proj,
                                 self.config, txt_embeds, imagine_embeds,
                                 imagine_mask, np_weights, rng, groups)

    def visual(self, txt_embeds, txt_mask, hist_embeds, hist_mask,
               ob_img_feats, ob_ang_feats, ob_nav_types, ob_valid,
               imagine_embeds=None, imagine_mask=None,
               obj_img_feats=None, obj_ang_feats=None, obj_valid=None,
               obj_pos_feats=None, rng=None) -> VisualOut:
        """Per-step cross-modal encoding + action logits
        (vilmodel_cmt.py:1056-1205).  With object inputs (REVERIE,
        vlnbert_navref.py:90-155) the visual stream is [hist; obs; obj]
        (then a visual-concat imagination) and obj_logits =
        ref_object(obj_embeds * txt[CLS]) masked by obj_valid."""
        cfg = self.config
        no_ca = cfg.no_lang_ca
        if no_ca:
            if cfg.imagine_enc_pano and cfg.concat_imagine_with == "language":
                raise ValueError(
                    "no_lang_ca + language-concat imagination is unsupported "
                    "(the reference path is inconsistent for this combo)")
            txt_stack, txt_embeds = txt_embeds, txt_embeds[0]
        ext_txt = extend_neg_mask(txt_mask)
        B, T_obs = ob_nav_types.shape
        with _stop_gradient(cfg.fix_obs_embedding):
            ob_img_feats = self.drop_env(ob_img_feats, rng)
            type_emb = self.embeddings.token_type_embeddings(
                torch.ones((B, T_obs), dtype=torch.long,
                           device=ob_nav_types.device))
            ob_embeds = self.img_embeddings(ob_img_feats, ob_ang_feats,
                                            type_emb, ob_nav_types, rng)

        hist_len = hist_embeds.shape[1]
        visn = torch.cat([hist_embeds, ob_embeds], dim=1)
        visn_mask = torch.cat([extend_neg_mask(hist_mask),
                               extend_neg_mask(ob_valid)], dim=-1)

        Ko = 0
        if cfg.obj_feat_size > 0 and obj_img_feats is not None:
            Ko = obj_img_feats.shape[1]
            obj_img_feats = self.drop_env(obj_img_feats, rng)
            ones = torch.ones((B, Ko), dtype=torch.long,
                              device=ob_nav_types.device)
            if obj_pos_feats is None:  # tables without bbox positions
                obj_pos_feats = obj_img_feats.new_zeros((B, Ko, 5))
            # objects carry the STOP nav type from the IMAGE module's
            # embedding table (vlnbert_navref.py:127-130)
            obj_embeds = self.obj_embeddings(
                obj_img_feats, obj_ang_feats, obj_pos_feats,
                self.embeddings.token_type_embeddings(ones),
                self.img_embeddings.nav_type_embedding(2 * ones), rng)
            visn = torch.cat([visn, obj_embeds], dim=1)
            visn_mask = torch.cat([visn_mask, extend_neg_mask(obj_valid)],
                                  dim=-1)

        lang, lang_mask = txt_embeds, ext_txt
        if cfg.imagine_enc_pano and cfg.concat_imagine_with == "language":
            lang = torch.cat([txt_embeds, imagine_embeds], dim=1)
            lang_mask = torch.cat([ext_txt, extend_neg_mask(imagine_mask)], dim=-1)
        elif cfg.imagine_enc_pano and cfg.concat_imagine_with == "visual":
            visn = torch.cat([visn, imagine_embeds], dim=1)
            visn_mask = torch.cat([visn_mask, extend_neg_mask(imagine_mask)],
                                  dim=-1)

        for li, layer in enumerate(self.encoder.x_layers):
            if no_ca:
                lang = txt_stack[li]  # per-layer static text (:1119-1121)
            lang, visn = layer(lang, lang_mask, visn, visn_mask, rng)

        hist_out = visn[:, :hist_len]
        ob_out = visn[:, hist_len:hist_len + T_obs]
        txt_len = txt_embeds.shape[1]
        txt_out = lang[:, :txt_len]
        if no_ca and Ko:
            # NavRefCMT hardcodes next_action(ob * hist[CLS]) regardless of
            # flags (vlnbert_navref.py:150); the released REVERIE recipe
            # runs it with --no_lang_ca (run_reverie.sh:27)
            head_in = ob_out * hist_out[:, :1]
        elif no_ca:
            head_in = ob_out  # (:1187-1188)
        elif cfg.act_pred_token == "ob_txt":
            head_in = ob_out * txt_out[:, :1]
        elif cfg.act_pred_token == "ob":
            head_in = ob_out
        elif cfg.act_pred_token == "ob_hist":
            head_in = ob_out * hist_out[:, :1]
        elif cfg.act_pred_token == "ob_txt_hist":
            head_in = ob_out * (txt_out[:, :1] + hist_out[:, :1])
        elif cfg.act_pred_token == "ob_imagine_text":
            # the mean over the imagination outputs: the language stream's
            # imagination tokens under language concat, else the embeddings
            imagine_out = (lang[:, txt_len:] if cfg.imagine_enc_pano
                           and cfg.concat_imagine_with == "language"
                           else imagine_embeds)
            head_in = ob_out * (txt_out[:, :1]
                                + imagine_out.mean(dim=1, keepdim=True))
        else:
            raise ValueError(cfg.act_pred_token)

        logits = self.next_action(head_in, rng)[..., 0]
        logits = mask_logits(logits, (ob_nav_types != 0) & ob_valid)
        # critic state: txt[CLS] * hist[CLS], or hist[CLS] under no_lang_ca
        # (model_HAMT.py:83-86)
        state = hist_out[:, 0] if no_ca else txt_out[:, 0] * hist_out[:, 0]
        obj_logits = None
        if Ko:
            obj_out = visn[:, hist_len + T_obs:hist_len + T_obs + Ko]
            obj_logits = self.ref_object(obj_out * txt_out[:, :1], rng)[..., 0]
            obj_logits = mask_logits(obj_logits, obj_valid)
        return VisualOut(logits, txt_out, hist_out, ob_out, state, obj_logits)
