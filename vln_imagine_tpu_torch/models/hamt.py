"""HAMT-Imagine: history-aware cross-modal transformer, in PyTorch.

The port of `vln_imagine_tpu/models/hamt.py` (itself a rebuild of NavCMT,
VLN-HAMT/finetune_src/models/vilmodel_cmt.py:966-1205, and its VLNBertCMT
wrapper, models/model_HAMT.py:13-97).  Each reference mode is a method:

- language  (vilmodel_cmt.py:1008-1030)
- history_initial / history_step (:1033-1038 + HistoryEmbeddings :546-618)
- imagine   (bypass variant :620-631, used by the released configs)
- align_with_contrastive_loss (:1050-1053 / AlignWithContrastiveLoss
  :730-790) as one masked segment-mean matmul
- visual    (:1056-1205), cross-modal streams [txt; imagine] x [hist; obs]

This slice carries the eval modes of the released R2R recipe: no ViT, no
REVERIE objects, no `no_lang_ca`, no full ImagineEmbeddings, and the cosine
alignment loss only.  Feature dropout is the identity in eval.
"""

from __future__ import annotations

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
from vln_imagine_tpu_torch.ops.masks import extend_neg_mask, mask_logits


class ImageEmbeddings(nn.Module):
    """img/angle linear+LN + nav-type + token-type -> LN
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

    def forward(self, img_feat, ang_feat, type_embeddings, nav_types):
        x = (self.img_layer_norm(self.img_linear(img_feat))
             + self.ang_layer_norm(self.ang_linear(ang_feat))
             + type_embeddings
             + self.nav_type_embedding(nav_types))
        return self.layer_norm(x)


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

    def _type(self, batch_size: int) -> torch.Tensor:
        ids = torch.zeros((batch_size,), dtype=torch.long,
                          device=self.cls_token.device)
        return self.type_embedding(ids)

    def initial(self, batch_size: int) -> torch.Tensor:
        """The [CLS]-style step-0 global history token (:592-595)."""
        x = self.cls_token[0, 0][None, :] + self._type(batch_size)
        return self.layer_norm(x)

    def forward(self, img_feats, ang_feats, step_ids, pano_img_feats,
                pano_ang_feats):
        B = img_feats.shape[0]
        x = (self.img_layer_norm(self.img_linear(img_feats))
             + self.ang_layer_norm(self.ang_linear(ang_feats))
             + self.position_embeddings(step_ids)
             + self._type(B))
        pano = (self.pano_img_layer_norm(self.pano_img_linear(pano_img_feats))
                + self.pano_ang_layer_norm(self.pano_ang_linear(pano_ang_feats)))
        zero_mask = torch.zeros((B, 1, 1, pano.shape[1]), dtype=torch.float32,
                                device=pano.device)
        pano = self.pano_encoder(pano, zero_mask)
        return self.layer_norm(x + pano.mean(dim=1))


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


class ContrastiveAlignment(nn.Module):
    """Holds the projection head under the reference's key names
    (`contrastive_alignment_model.image_proj.*`)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.image_proj = MLPProjectionHead(cfg)


def contrastive_alignment_loss(proj, mean_np, valid, aux_loss_type="cosine"):
    """Cosine alignment: mean over valid rows of 1 - cos(proj, mean_np)
    (AlignWithContrastiveLoss, vilmodel_cmt.py:777-788)."""
    if aux_loss_type != "cosine":
        raise NotImplementedError(f"aux_loss_type {aux_loss_type!r} is not ported yet")

    def unit(x):
        x = x.float()
        return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                               min=1e-8)

    pos_sim = torch.sum(unit(proj) * unit(mean_np), dim=-1)   # [B, I]
    v = valid.float()
    return torch.sum((1.0 - pos_sim) * v) / torch.clamp(torch.sum(v), min=1.0)


class VisualOut(NamedTuple):
    act_logits: torch.Tensor   # [B, T_obs]
    txt_embeds: torch.Tensor   # [B, L, H]
    hist_embeds: torch.Tensor  # [B, T, H]
    ob_embeds: torch.Tensor    # [B, T_obs, H]
    state: torch.Tensor        # [B, H] critic state txt[CLS] * hist[CLS]


class HamtEncoder(nn.Module):
    """Container for the reference's `encoder.layer.*` / `encoder.x_layers.*`
    keys."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_l_layers))
        self.x_layers = nn.ModuleList(
            LXRTXLayer(cfg) for _ in range(cfg.num_x_layers))


class HamtModel(nn.Module):
    """NavCMT + the VLNBertCMT wrapper, one module (eval modes)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        unported = {"no_lang_ca": cfg.no_lang_ca,
                    "obj_feat_size": cfg.obj_feat_size > 0,
                    "e2e_imagination": cfg.e2e_imagination != "off",
                    "bypass_imag_encoder=False": (cfg.imagine_enc_pano
                                                  and not cfg.bypass_imag_encoder)}
        if any(unported.values()):
            raise NotImplementedError(
                f"not ported yet: {[k for k, v in unported.items() if v]}")
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.img_embeddings = ImageEmbeddings(cfg)
        self.hist_embeddings = HistoryEmbeddings(cfg)
        if cfg.imagine_enc_pano:
            self.imagine_embeddings = BypassImagineEmbeddings(cfg)
            if cfg.use_cosine_aux_loss or cfg.no_loss_test:
                self.contrastive_alignment_model = ContrastiveAlignment(cfg)
        self.encoder = HamtEncoder(cfg)
        self.next_action = NextActionPrediction(cfg)

    # ------------------------------------------------------------------ modes
    def language(self, txt_ids, txt_mask):
        ext = extend_neg_mask(txt_mask)
        x = self.embeddings(txt_ids)
        for layer in self.encoder.layer:
            x = layer(x, ext)
        return x

    def history_initial(self, batch_size: int):
        return self.hist_embeddings.initial(batch_size)

    def history_step(self, hist_img_feats, prev_act_angle, step_id: int,
                     pano_img_feats, pano_ang_feats):
        """One new history token for time `step_id` (agent_cmt.py:596-605)."""
        B = hist_img_feats.shape[0]
        step_ids = torch.full((B,), step_id, dtype=torch.long,
                              device=hist_img_feats.device)
        return self.hist_embeddings(hist_img_feats, prev_act_angle, step_ids,
                                    pano_img_feats, pano_ang_feats)

    def imagine(self, imagine_feats, imagine_mask=None):
        return self.imagine_embeddings(imagine_feats)

    def align_with_contrastive_loss(self, txt_embeds, txt_mask, imagine_embeds,
                                    imagine_mask, np_weights):
        """Alignment of projected imagination embeddings to the mean
        noun-phrase token embedding of their sub-instruction.  Returns
        (loss, new_imagine): valid rows are overwritten with their
        projection, the reference's in-place update (vilmodel_cmt.py:781)."""
        proj = self.contrastive_alignment_model.image_proj(imagine_embeds)
        mean_np = torch.einsum("bil,blh->bih", np_weights.to(txt_embeds.dtype),
                               txt_embeds)
        valid = imagine_mask & (torch.sum(np_weights, dim=-1) > 0)
        loss = contrastive_alignment_loss(proj, mean_np, valid,
                                          self.config.aux_loss_type)
        new_imagine = torch.where(valid[:, :, None], proj, imagine_embeds)
        return loss, new_imagine

    def visual(self, txt_embeds, txt_mask, hist_embeds, hist_mask,
               ob_img_feats, ob_ang_feats, ob_nav_types, ob_valid,
               imagine_embeds=None, imagine_mask=None) -> VisualOut:
        """Per-step cross-modal encoding + action logits
        (vilmodel_cmt.py:1056-1205)."""
        cfg = self.config
        ext_txt = extend_neg_mask(txt_mask)
        B, T_obs = ob_nav_types.shape
        type_emb = self.embeddings.token_type_embeddings(
            torch.ones((B, T_obs), dtype=torch.long, device=ob_nav_types.device))
        ob_embeds = self.img_embeddings(ob_img_feats, ob_ang_feats, type_emb,
                                        ob_nav_types)

        hist_len = hist_embeds.shape[1]
        visn = torch.cat([hist_embeds, ob_embeds], dim=1)
        visn_mask = torch.cat([extend_neg_mask(hist_mask),
                               extend_neg_mask(ob_valid)], dim=-1)
        lang, lang_mask = txt_embeds, ext_txt
        if cfg.imagine_enc_pano and cfg.concat_imagine_with == "language":
            lang = torch.cat([txt_embeds, imagine_embeds], dim=1)
            lang_mask = torch.cat([ext_txt, extend_neg_mask(imagine_mask)], dim=-1)
        elif cfg.imagine_enc_pano and cfg.concat_imagine_with == "visual":
            visn = torch.cat([visn, imagine_embeds], dim=1)
            visn_mask = torch.cat([visn_mask, extend_neg_mask(imagine_mask)],
                                  dim=-1)

        for layer in self.encoder.x_layers:
            lang, visn = layer(lang, lang_mask, visn, visn_mask)

        hist_out = visn[:, :hist_len]
        ob_out = visn[:, hist_len:hist_len + T_obs]
        txt_out = lang[:, :txt_embeds.shape[1]]
        if cfg.act_pred_token == "ob_txt":
            head_in = ob_out * txt_out[:, :1]
        elif cfg.act_pred_token == "ob":
            head_in = ob_out
        elif cfg.act_pred_token == "ob_hist":
            head_in = ob_out * hist_out[:, :1]
        elif cfg.act_pred_token == "ob_txt_hist":
            head_in = ob_out * (txt_out[:, :1] + hist_out[:, :1])
        else:
            raise NotImplementedError(f"act_pred_token {cfg.act_pred_token!r}")

        logits = self.next_action(head_in)[..., 0]
        logits = mask_logits(logits, (ob_nav_types != 0) & ob_valid)
        state = txt_out[:, 0] * hist_out[:, 0]
        return VisualOut(logits, txt_out, hist_out, ob_out, state)
