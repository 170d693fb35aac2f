"""DUET pre-training model: the path-trajectory backbone and the MLM / MRC /
SAP / OG heads.

The port of `vln_imagine_tpu/pretrain/duet_model.py` (a rebuild of
GlocalTextPathCMT + GlocalTextPathCMTPreTraining,
VLN-DUET/pretrain_src/model/vilmodel.py:648-747, pretrain_cmt.py:38-365).
The backbone sits under `bert` with the navigator's module names
(`bert.embeddings`, `bert.lang_encoder`, `bert.img_embeddings`,
`bert.local_encoder`, `bert.global_encoder`), the heads beside it
(`mlm_head.predictions.*`, `global_sap_head`, `local_sap_head`,
`sap_fuse_linear`, `og_head`: the reference's names; `image_classifier`:
the JAX package's), so a snapshot initialises fine-tuning by a key-matched
copy (ckpt/transfer.py).

The model holds the JAX package's leaf set for its tasks (flax creates a
parameter at its first use): the cross-modal layers' language side only
with `mlm`, their visual side and `sprel_linear` only with `mrc`, `sap` or
`og`, each head only with its task.

The data pipeline gives a row-normalised aggregation matrix Agg[B, G, T*Tp]
(visited node -> its last visit's pano tokens averaged, unvisited -> the
mean over its candidate occurrences); the model reduces the trajectory
tokens with it in one batched product in the compute dtype.

`mrc` and `og` read the local branch alone (JAX `duet_model.py:181-184`,
`:246-249` discard the global branch's output, so XLA drops its work);
here the global branch is not run for them.  Each `forward_<task>` returns
(loss_sum, n, n_correct); `rng` turns dropout on (ops/dropout.py).
"""

from __future__ import annotations

import torch
from torch import nn

from vln_imagine_tpu_torch.config import ModelConfig
from vln_imagine_tpu_torch.models.bert import (
    BertEmbeddings,
    BertEncoder,
    ClsPrediction,
)
from vln_imagine_tpu_torch.models.duet import (
    GlobalEncoder,
    ImageEmbeddings,
    LocalEncoder,
    fused_logit_merge,
)
from vln_imagine_tpu_torch.ops.dropout import dropout
from vln_imagine_tpu_torch.ops.masks import extend_neg_mask, mask_logits
from vln_imagine_tpu_torch.pretrain.hamt_model import MLMHead, MLPHead

_VISUAL_TASKS = ("mrc", "sap", "og")  # the tasks that read the visual side


class DuetBackbone(nn.Module):
    """GlocalTextPathCMT's modules under the navigator's names."""

    def __init__(self, cfg: ModelConfig, tasks: tuple):
        super().__init__()
        lang = "mlm" in tasks
        visn = any(t in tasks for t in _VISUAL_TASKS)
        self.embeddings = BertEmbeddings(cfg)
        self.lang_encoder = BertEncoder(cfg, cfg.num_l_layers)
        self.img_embeddings = ImageEmbeddings(cfg, objects=False)
        self.local_encoder = LocalEncoder(cfg, lang, visn)
        self.global_encoder = GlobalEncoder(cfg, lang, visn)


def _log_softmax(x):
    return torch.log_softmax(x.float(), -1)


def _ce(logits, labels):
    return -_log_softmax(logits).gather(1, labels.long()[:, None])[:, 0]


class DuetPretrainModel(nn.Module):
    def __init__(self, cfg: ModelConfig, image_prob_size: int = 1000,
                 tasks: tuple = ("mlm", "mrc", "sap")):
        super().__init__()
        self.config = cfg
        self.bert = DuetBackbone(cfg, tasks)
        if "mlm" in tasks:
            self.mlm_head = MLMHead(cfg)
        if "mrc" in tasks:
            self.image_classifier = MLPHead(cfg, cfg.hidden_size,
                                            image_prob_size, dropout=False)
        if "sap" in tasks:
            self.global_sap_head = ClsPrediction(cfg)
            self.local_sap_head = ClsPrediction(cfg)
            if cfg.glocal_fuse:
                self.sap_fuse_linear = ClsPrediction(
                    cfg, input_size=2 * cfg.hidden_size)
        if "og" in tasks:
            self.og_head = ClsPrediction(cfg)

    # ----------------------------------------------------------- backbone
    def _text(self, txt_ids, txt_masks, rng):
        b = self.bert
        return b.lang_encoder(b.embeddings(txt_ids, rng),
                              extend_neg_mask(txt_masks), rng)

    def _traj_pano(self, traj_img, traj_loc, traj_nav, traj_valid, rng):
        """Every step's pano token embeddings at once (ImageEmbeddings.
        forward, vilmodel.py:484-526): [B, T, Tp, H]."""
        B, T, Tp = traj_nav.shape
        emb = self.bert.img_embeddings
        type_ids = torch.ones((1, 1), dtype=torch.long, device=traj_nav.device)
        x = emb.img_layer_norm(emb.img_linear(traj_img.flatten(0, 1)))
        x = (x + emb.loc_layer_norm(emb.loc_linear(traj_loc.flatten(0, 1)))
             + emb.nav_type_embedding(traj_nav.flatten(0, 1))
             + self.bert.embeddings.token_type_embedding(type_ids))
        x = dropout(emb.layer_norm(x), self.config.hidden_dropout_prob, rng)
        x = emb.pano_encoder(x, key_padding_mask=traj_valid.flatten(0, 1),
                             rng=rng)
        return x.reshape(B, T, Tp, -1)

    def _gmap_inputs(self, traj, agg, gmap_step_ids, gmap_pos_fts):
        """[stop] + aggregated node embeddings + step and position
        embeddings (GlobalMapEncoder.gmap_input_embedding,
        vilmodel.py:974-985)."""
        B, T, Tp, H = traj.shape
        flat = traj.reshape(B, T * Tp, H)
        nodes = torch.bmm(agg.to(flat.dtype), flat)
        glob = self.bert.global_encoder
        return (torch.cat([flat.new_zeros(B, 1, H), nodes], 1)
                + glob.gmap_step_embeddings(gmap_step_ids)
                + glob.gmap_pos_embeddings["1"](
                    glob.gmap_pos_embeddings["0"](gmap_pos_fts)))

    def _vp_inputs(self, traj, vp_pos_fts):
        """[stop] + the last step's pano tokens + the viewpoint position
        embedding (LocalVPEncoder.vp_input_embedding, vilmodel.py:537-551)."""
        last = traj[:, -1]
        loc = self.bert.local_encoder
        return (torch.cat([last.new_zeros(last.shape[0], 1, last.shape[-1]),
                           last], 1)
                + loc.vp_pos_embeddings["1"](
                    loc.vp_pos_embeddings["0"](vp_pos_fts)))

    def _global(self, txt, txt_masks, traj, agg, gmap_step_ids, gmap_pos_fts,
                gmap_valid, gmap_pair_dists, rng):
        glob = self.bert.global_encoder
        sprels = None
        if self.config.graph_sprels:
            sprels = glob.sprel_linear(gmap_pair_dists[..., None])[..., 0][
                :, None]
        return glob.encoder(txt, txt_masks,
                            self._gmap_inputs(traj, agg, gmap_step_ids,
                                              gmap_pos_fts),
                            gmap_valid, sprels, rng)

    def _local(self, txt, txt_masks, traj, vp_pos_fts, vp_valid, rng):
        return self.bert.local_encoder.encoder(
            txt, txt_masks, self._vp_inputs(traj, vp_pos_fts), vp_valid,
            None, rng)

    # -------------------------------------------------------------- tasks
    def forward_mlm(self, txt_ids, txt_masks, txt_labels, traj_img,
                    traj_loc, traj_nav, traj_valid, agg, gmap_step_ids,
                    gmap_pos_fts, gmap_valid, vp_pos_fts, vp_valid,
                    rng=None):
        """The language queries both branches (lang2visn); the two text
        streams, summed, feed the MLM head (pretrain vilmodel.py:700-747).
        Labels -1 = unmasked."""
        txt = self._text(txt_ids, txt_masks, rng)
        traj = self._traj_pano(traj_img, traj_loc, traj_nav, traj_valid, rng)
        b = self.bert
        out = (b.global_encoder.encoder.lang2visn_stack(
                   txt, txt_masks,
                   self._gmap_inputs(traj, agg, gmap_step_ids, gmap_pos_fts),
                   gmap_valid, rng)
               + b.local_encoder.encoder.lang2visn_stack(
                   txt, txt_masks, self._vp_inputs(traj, vp_pos_fts),
                   vp_valid, rng))
        logits = self.mlm_head(out, b.embeddings.word_embeddings.weight)
        logp = _log_softmax(logits)
        is_masked = txt_labels >= 0
        tgt = txt_labels.clamp(0, logits.shape[-1] - 1).long()
        ce = -logp.gather(-1, tgt[..., None])[..., 0]
        correct = ((logits.argmax(-1) == tgt) & is_masked).sum()
        return (ce * is_masked).sum(), is_masked.sum(), correct

    def forward_mrc(self, txt_ids, txt_masks, traj_img, traj_loc, traj_nav,
                    traj_valid, agg, gmap_step_ids, gmap_pos_fts, gmap_valid,
                    gmap_pair_dists, vp_pos_fts, vp_valid, vp_view_mrc_masks,
                    vp_view_probs, rng=None):
        """KL on the masked last-step view tokens (pretrain_cmt.py:159-268);
        the data pipeline zeroes the masked views' features."""
        txt = self._text(txt_ids, txt_masks, rng)
        traj = self._traj_pano(traj_img, traj_loc, traj_nav, traj_valid, rng)
        vp_embeds = self._local(txt, txt_masks, traj, vp_pos_fts, vp_valid,
                                rng)
        pred = self.image_classifier(vp_embeds[:, 1:], rng)  # drop stop
        p = vp_view_probs
        kl = (p * (torch.log(p.clamp(min=1e-12)) - _log_softmax(pred))).sum(-1)
        masks = vp_view_mrc_masks
        correct = ((pred.argmax(-1) == p.argmax(-1)) & masks).sum()
        return (kl * masks).sum(), masks.sum(), correct

    def forward_sap(self, txt_ids, txt_masks, traj_img, traj_loc, traj_nav,
                    traj_valid, agg, gmap_step_ids, gmap_pos_fts, gmap_valid,
                    gmap_pair_dists, gmap_visited, vp_pos_fts, vp_valid,
                    vp_nav_valid, cand_to_gmap, global_act_labels,
                    local_act_labels, rng=None):
        """Global + local + fused CE (pretrain_cmt.py:212-286)."""
        txt = self._text(txt_ids, txt_masks, rng)
        traj = self._traj_pano(traj_img, traj_loc, traj_nav, traj_valid, rng)
        gmap_embeds = self._global(txt, txt_masks, traj, agg, gmap_step_ids,
                                   gmap_pos_fts, gmap_valid, gmap_pair_dists,
                                   rng)
        vp_embeds = self._local(txt, txt_masks, traj, vp_pos_fts, vp_valid,
                                rng)
        if self.config.glocal_fuse:
            fuse = torch.sigmoid(self.sap_fuse_linear(
                torch.cat([gmap_embeds[:, 0], vp_embeds[:, 0]], -1)))
        else:
            fuse = torch.full((txt.shape[0], 1), 0.5, dtype=txt.dtype,
                              device=txt.device)
        global_logits = mask_logits(
            self.global_sap_head(gmap_embeds)[..., 0] * fuse,
            ~gmap_visited & gmap_valid)
        local_logits = mask_logits(
            self.local_sap_head(vp_embeds)[..., 0] * (1 - fuse), vp_nav_valid)
        fused = fused_logit_merge(global_logits, local_logits, gmap_visited,
                                  gmap_valid, vp_nav_valid, cand_to_gmap)
        losses = (_ce(global_logits, global_act_labels)
                  + _ce(local_logits, local_act_labels)
                  + _ce(fused, global_act_labels))
        correct = (fused.argmax(-1) == global_act_labels).sum()
        return losses.sum(), txt_ids.shape[0], correct

    def forward_og(self, txt_ids, txt_masks, traj_img, traj_loc, traj_nav,
                   traj_valid, agg, gmap_step_ids, gmap_pos_fts, gmap_valid,
                   gmap_pair_dists, vp_pos_fts, vp_valid, vp_obj_valid,
                   obj_labels, rng=None):
        """Object grounding CE on the last step's object tokens
        (pretrain_cmt.py:288-320); labels -100 = no visible target."""
        txt = self._text(txt_ids, txt_masks, rng)
        traj = self._traj_pano(traj_img, traj_loc, traj_nav, traj_valid, rng)
        vp_embeds = self._local(txt, txt_masks, traj, vp_pos_fts, vp_valid,
                                rng)
        logits = mask_logits(self.og_head(vp_embeds)[..., 0], vp_obj_valid)
        has = obj_labels >= 0
        tgt = obj_labels.clamp(0, logits.shape[1] - 1)
        ce = _ce(logits, tgt)
        correct = ((logits.argmax(-1) == tgt) & has).sum()
        return (ce * has).sum(), has.sum(), correct
