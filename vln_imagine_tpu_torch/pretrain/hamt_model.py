"""HAMT pre-training model: the backbone and the six proxy-task heads.

The port of `vln_imagine_tpu/pretrain/hamt_model.py` (a rebuild of
NavPreTrainedModel + MultiStepNavCMTPreTraining,
VLN-HAMT/pretrain_src/model/vilmodel.py:578-724, pretrain_cmt.py:13-262).
The backbone reuses the fine-tune HamtModel's submodules under the same
keys (`embeddings`, `img_embeddings`, `hist_embeddings`, `encoder.layer.*`,
`encoder.x_layers.*`, `next_action`), so a snapshot initialises fine-tuning
by a key-matched copy (ckpt/transfer.py).

Tasks: mlm (masked LM, decoder tied to the word embeddings: one
Parameter, so both uses add to one gradient), sap (single-step action
prediction), sar (action heading / elevation / progress regression), sprel
(relative heading / elevation between views), mrc (masked region
classification against ViT class probabilities, KL), itm (instruction-
trajectory matching with in-batch and shuffled-order negatives).  Each
`forward_<task>` returns (loss_sum, n, n_correct); `rng` turns dropout on
(ops/dropout.py), without it dropout is off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vln_imagine_tpu_torch.config import ModelConfig
from vln_imagine_tpu_torch.models.bert import (
    BertEmbeddings,
    Dense,
    LayerNorm12,
    NextActionPrediction,
    compute_dtype,
    gelu_erf,
)
from vln_imagine_tpu_torch.models.hamt import (
    HamtEncoder,
    HistoryEmbeddings,
    ImageEmbeddings,
)
from vln_imagine_tpu_torch.ops.dropout import dropout
from vln_imagine_tpu_torch.ops.masks import extend_neg_mask, mask_logits

TASKS = ("mlm", "sap", "sar", "sprel", "mrc", "itm")


class _Transform(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size, compute_dtype(cfg))
        self.LayerNorm = LayerNorm12(cfg.hidden_size)

    def forward(self, x):
        return self.LayerNorm(gelu_erf(self.dense(x)))


class _LMPrediction(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.transform = _Transform(cfg)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))


class MLMHead(nn.Module):
    """BertLMPredictionHead (vilmodel_cmt.py:274-290) under a BERT
    checkpoint's keys (`mlm_head.predictions.*`): transform, then the tied
    decoder and its bias."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.predictions = _LMPrediction(cfg)

    def forward(self, hidden, word_embedding: torch.Tensor):
        x = self.predictions.transform(hidden)
        logits = torch.einsum("...h,vh->...v", x, word_embedding.to(x.dtype))
        return logits + self.predictions.bias


class MLPHead(nn.Module):
    """Linear -> ReLU -> LN -> [dropout] -> Linear(out_dim)
    (pretrain_cmt.py:13-71 family), under the flax names."""

    def __init__(self, cfg: ModelConfig, in_dim: int, out_dim: int,
                 dropout: bool = True):
        super().__init__()
        dt = compute_dtype(cfg)
        self.dense0 = Dense(in_dim, cfg.hidden_size, dt)
        self.LayerNorm = LayerNorm12(cfg.hidden_size)
        self.dense1 = Dense(cfg.hidden_size, out_dim, dt)
        self.rate = cfg.pred_head_dropout_prob if dropout else 0.0

    def forward(self, x, rng=None):
        x = self.LayerNorm(F.relu(self.dense0(x)))
        return self.dense1(dropout(x, self.rate, rng))


def _log_softmax(x):
    return torch.log_softmax(x.float(), -1)


class HamtPretrainModel(nn.Module):
    def __init__(self, cfg: ModelConfig, image_prob_size: int = 1000,
                 tasks: tuple = TASKS):
        super().__init__()
        self.config = cfg
        H = cfg.hidden_size
        self.embeddings = BertEmbeddings(cfg)
        self.img_embeddings = ImageEmbeddings(cfg)
        self.hist_embeddings = HistoryEmbeddings(cfg)
        self.encoder = HamtEncoder(cfg)
        if "mlm" in tasks:
            self.mlm_head = MLMHead(cfg)
        if "sap" in tasks:
            self.next_action = NextActionPrediction(cfg)
        if "sar" in tasks:
            self.regress_action = MLPHead(cfg, H, 3)
        if "sprel" in tasks:
            self.sprel_head = MLPHead(cfg, 2 * H, 2)
        if "mrc" in tasks:
            self.image_classifier = MLPHead(cfg, H, image_prob_size,
                                            dropout=False)
        if "itm" in tasks:
            self.itm_head = MLPHead(cfg, H, 1, dropout=False)

    # ----------------------------------------------------------- backbone
    def _text(self, txt_ids, ext_txt, rng):
        x = self.embeddings(txt_ids, rng)
        for layer in self.encoder.layer:
            x = layer(x, ext_txt, rng)
        return x

    def _history_tokens(self, hist_img_fts, hist_ang_fts, hist_pano_img_fts,
                        hist_pano_ang_fts, rng, pos_ids=None):
        """[CLS-global] + one token per history step, [B, T+1, H]
        (pretrain vilmodel.py:520-575)."""
        B, T = hist_img_fts.shape[:2]
        cls = self.hist_embeddings.initial(B, rng)
        if pos_ids is None:
            step_ids = torch.arange(T, device=hist_img_fts.device).repeat(B)
        else:
            step_ids = pos_ids.reshape(B * T)
        toks = self.hist_embeddings(
            hist_img_fts.flatten(0, 1), hist_ang_fts.flatten(0, 1), step_ids,
            hist_pano_img_fts.flatten(0, 1), hist_pano_ang_fts.flatten(0, 1),
            rng)
        return torch.cat([cls[:, None, :], toks.reshape(B, T, -1)], 1)

    def backbone(self, txt_ids, txt_masks, hist_img_fts, hist_ang_fts,
                 hist_pano_img_fts, hist_pano_ang_fts, hist_masks,
                 ob_img_fts=None, ob_ang_fts=None, ob_nav_types=None,
                 ob_masks=None, rng=None):
        """NavPreTrainedModel.forward (pretrain vilmodel.py:591-638):
        (txt, hist, ob or None)."""
        ext_txt = extend_neg_mask(txt_masks)
        txt = self._text(txt_ids, ext_txt, rng)
        visn = self._history_tokens(hist_img_fts, hist_ang_fts,
                                    hist_pano_img_fts, hist_pano_ang_fts, rng)
        visn_mask = extend_neg_mask(hist_masks)
        hist_len = visn.shape[1]
        if ob_img_fts is not None:
            B = ob_nav_types.shape[0]
            type_emb = self.embeddings.token_type_embeddings(
                torch.ones((B, 1), dtype=torch.long, device=txt_ids.device))
            ob = self.img_embeddings(ob_img_fts, ob_ang_fts, type_emb,
                                     ob_nav_types, rng)
            visn = torch.cat([visn, ob], 1)
            visn_mask = torch.cat([visn_mask, extend_neg_mask(ob_masks)], -1)
        for layer in self.encoder.x_layers:
            txt, visn = layer(txt, ext_txt, visn, visn_mask, rng)
        ob_out = visn[:, hist_len:] if ob_img_fts is not None else None
        return txt, visn[:, :hist_len], ob_out

    # -------------------------------------------------------------- tasks
    def forward_mlm(self, txt_ids, txt_masks, hist_img_fts, hist_ang_fts,
                    hist_pano_img_fts, hist_pano_ang_fts, hist_masks,
                    txt_labels, rng=None):
        """Per-token CE on masked positions (pretrain_cmt.py:142-159);
        labels -1 = unmasked."""
        txt, _, _ = self.backbone(txt_ids, txt_masks, hist_img_fts,
                                  hist_ang_fts, hist_pano_img_fts,
                                  hist_pano_ang_fts, hist_masks, rng=rng)
        logits = self.mlm_head(txt, self.embeddings.word_embeddings.weight)
        logp = _log_softmax(logits)
        is_masked = txt_labels >= 0
        tgt = txt_labels.clamp(0, logits.shape[-1] - 1).long()
        ce = -logp.gather(-1, tgt[..., None])[..., 0]
        correct = ((logits.argmax(-1) == tgt) & is_masked).sum()
        return (ce * is_masked).sum(), is_masked.sum(), correct

    def forward_sap(self, txt_ids, txt_masks, hist_img_fts, hist_ang_fts,
                    hist_pano_img_fts, hist_pano_ang_fts, hist_masks,
                    ob_img_fts, ob_ang_fts, ob_nav_types, ob_masks,
                    act_labels, rng=None):
        """CE over the observation tokens (pretrain_cmt.py:167-183)."""
        txt, _, ob = self.backbone(
            txt_ids, txt_masks, hist_img_fts, hist_ang_fts, hist_pano_img_fts,
            hist_pano_ang_fts, hist_masks, ob_img_fts, ob_ang_fts,
            ob_nav_types, ob_masks, rng)
        logits = self.next_action(ob * txt[:, :1], rng)[..., 0]
        logits = mask_logits(logits, (ob_nav_types != 0) & ob_masks)
        act = act_labels.long()
        ce = -_log_softmax(logits).gather(1, act[:, None])[:, 0]
        correct = (logits.argmax(-1) == act).sum()
        return ce.sum(), act.shape[0], correct

    def forward_sar(self, txt_ids, txt_masks, hist_img_fts, hist_ang_fts,
                    hist_pano_img_fts, hist_pano_ang_fts, hist_masks,
                    ob_img_fts, ob_ang_fts, ob_nav_types, ob_masks,
                    ob_act_angles, ob_progress, rng=None):
        """MSE on (heading, elevation, progress) from txt[CLS]
        (pretrain_cmt.py:185-200)."""
        txt, _, _ = self.backbone(
            txt_ids, txt_masks, hist_img_fts, hist_ang_fts, hist_pano_img_fts,
            hist_pano_ang_fts, hist_masks, ob_img_fts, ob_ang_fts,
            ob_nav_types, ob_masks, rng)
        pred = self.regress_action(txt[:, 0], rng)
        target = torch.cat([ob_act_angles, ob_progress[:, None]], -1)
        err = (pred.float() - target) ** 2
        return err.sum(), err.numel(), err.sum()

    def forward_sprel(self, txt_ids, txt_masks, hist_img_fts, hist_ang_fts,
                      hist_pano_img_fts, hist_pano_ang_fts, hist_masks,
                      ob_img_fts, ob_ang_fts, ob_nav_types, ob_masks,
                      sp_anchor_idxs, sp_targets, rng=None):
        """MSE on the relative (heading, elevation) of every view against
        an anchor view (pretrain_cmt.py:202-222)."""
        txt, _, ob = self.backbone(
            txt_ids, txt_masks, hist_img_fts, hist_ang_fts, hist_pano_img_fts,
            hist_pano_ang_fts, hist_masks, ob_img_fts, ob_ang_fts,
            ob_nav_types, ob_masks, rng)
        idx = sp_anchor_idxs.long()[:, None, None].expand(-1, 1, ob.shape[-1])
        anchor = ob.gather(1, idx)
        V = sp_targets.shape[1]
        cat = torch.cat([anchor.expand_as(ob[:, :V]), ob[:, :V]], -1)
        err = (self.sprel_head(cat, rng).float() - sp_targets) ** 2
        return err.sum(), err.numel(), err.sum()

    def forward_mrc(self, txt_ids, txt_masks, hist_img_fts, hist_ang_fts,
                    hist_pano_img_fts, hist_pano_ang_fts, hist_masks,
                    hist_mrc_masks, hist_img_probs, rng=None):
        """KL(ViT class probabilities || predicted distribution) on the
        masked history steps (pretrain_cmt.py:224-243)."""
        _, hist, _ = self.backbone(txt_ids, txt_masks, hist_img_fts,
                                   hist_ang_fts, hist_pano_img_fts,
                                   hist_pano_ang_fts, hist_masks, rng=rng)
        pred = self.image_classifier(hist[:, 1:], rng)
        logp = _log_softmax(pred)
        p = hist_img_probs
        kl = (p * (torch.log(p.clamp(min=1e-12)) - logp)).sum(-1)
        correct = ((pred.argmax(-1) == p.argmax(-1)) & hist_mrc_masks).sum()
        return (kl * hist_mrc_masks).sum(), hist_mrc_masks.sum(), correct

    def forward_itm(self, txt_ids, txt_masks, hist_img_fts, hist_ang_fts,
                    hist_pano_img_fts, hist_pano_ang_fts, hist_masks,
                    neg_idxs, shuffled_pos_ids, rng=None):
        """Instruction-trajectory matching (pretrain vilmodel.py:640-724,
        pretrain_cmt.py:245-262): the positive, in-batch negatives
        (neg_idxs [B, K1]) and order-shuffled negatives (shuffled_pos_ids
        [K2, B, T]); CE with the positive at index 0."""
        ext_txt = extend_neg_mask(txt_masks)
        txt = self._text(txt_ids, ext_txt, rng)

        def hist_tokens(pos_ids=None):
            return self._history_tokens(hist_img_fts, hist_ang_fts,
                                        hist_pano_img_fts, hist_pano_ang_fts,
                                        rng, pos_ids=pos_ids)

        pos_hist = hist_tokens()
        cands, cand_masks = [pos_hist], [hist_masks]
        for k in range(neg_idxs.shape[1]):
            idx = neg_idxs[:, k].long()
            cands.append(pos_hist[idx])
            cand_masks.append(hist_masks[idx])
        for k in range(shuffled_pos_ids.shape[0]):
            cands.append(hist_tokens(pos_ids=shuffled_pos_ids[k]))
            cand_masks.append(hist_masks)
        n_cand, B = len(cands), txt_ids.shape[0]
        visn = torch.cat(cands, 0)
        visn_mask = extend_neg_mask(torch.cat(cand_masks, 0))
        txt_rep = txt.repeat(n_cand, 1, 1)
        txt_mask_rep = ext_txt.repeat(n_cand, 1, 1, 1)
        for layer in self.encoder.x_layers:
            txt_rep, visn = layer(txt_rep, txt_mask_rep, visn, visn_mask, rng)
        scores = self.itm_head(txt_rep[:, 0] * visn[:, 0], rng)[..., 0]
        scores = scores.reshape(n_cand, B).T  # [B, 1 + negatives]
        ce = -_log_softmax(scores)[:, 0]
        correct = (scores.argmax(-1) == 0).sum()
        return ce.sum(), B, correct
