"""End-to-end image pre-training: the ViT inside the training step.

The port of `vln_imagine_tpu/pretrain/hamt_e2e.py` (a rebuild of
NavTHORImagePreTrainedModel, VLN-HAMT/pretrain_src/model/
image_vilmodel.py:22-209): raw panorama and observation images are
embedded by an in-model ViT-B/16 in place of precomputed features.  As in
the reference's `forward_vision_backbone` (:40-59) the history panoramas
run with no gradient: here under `torch.no_grad()`, so their 36 views a
step keep no activations; the per-step history views and the observation
images keep theirs and train the ViT.  The six tasks then run on
`HamtPretrainModel` (`head_model`); MRC masks the ViT's output features
after the backbone (image_vilmodel.py:83-85).
"""

from __future__ import annotations

import torch
from torch import nn

from vln_imagine_tpu_torch.config import ModelConfig
from vln_imagine_tpu_torch.models.vit import ViTConfig, VisionTransformer
from vln_imagine_tpu_torch.pretrain.hamt_model import TASKS, HamtPretrainModel


class HamtE2EPretrainModel(nn.Module):
    def __init__(self, cfg: ModelConfig, vit_config: ViTConfig | None = None,
                 image_prob_size: int = 1000, tasks: tuple = TASKS):
        super().__init__()
        self.config = cfg
        self.vit = VisionTransformer(vit_config or ViTConfig())
        self.head_model = HamtPretrainModel(cfg, image_prob_size, tasks)

    def _embed(self, images, grad: bool):
        """[..., H, W, 3] -> [..., D] class-token features."""
        lead = images.shape[:-3]
        with torch.set_grad_enabled(grad and torch.is_grad_enabled()):
            feats, _ = self.vit(images.reshape((-1,) + tuple(images.shape[-3:])))
        return feats.reshape(tuple(lead) + (feats.shape[-1],))

    def _hist_and_obs(self, hist_images, hist_pano_images, ob_images=None):
        return (self._embed(hist_images, grad=True),
                self._embed(hist_pano_images, grad=False),
                None if ob_images is None else self._embed(ob_images, True))

    def forward_mlm(self, txt_ids, txt_masks, hist_images, hist_ang_fts,
                    hist_pano_images, hist_pano_ang_fts, hist_masks,
                    txt_labels, rng=None):
        h, hp, _ = self._hist_and_obs(hist_images, hist_pano_images)
        return self.head_model.forward_mlm(
            txt_ids, txt_masks, h, hist_ang_fts, hp, hist_pano_ang_fts,
            hist_masks, txt_labels, rng)

    def forward_sap(self, txt_ids, txt_masks, hist_images, hist_ang_fts,
                    hist_pano_images, hist_pano_ang_fts, hist_masks,
                    ob_images, ob_ang_fts, ob_nav_types, ob_masks,
                    act_labels, rng=None):
        h, hp, ob = self._hist_and_obs(hist_images, hist_pano_images,
                                       ob_images)
        return self.head_model.forward_sap(
            txt_ids, txt_masks, h, hist_ang_fts, hp, hist_pano_ang_fts,
            hist_masks, ob, ob_ang_fts, ob_nav_types, ob_masks, act_labels,
            rng)

    def forward_sar(self, txt_ids, txt_masks, hist_images, hist_ang_fts,
                    hist_pano_images, hist_pano_ang_fts, hist_masks,
                    ob_images, ob_ang_fts, ob_nav_types, ob_masks,
                    ob_act_angles, ob_progress, rng=None):
        """SarImageDataset (image_tasks.py:253-351)."""
        h, hp, ob = self._hist_and_obs(hist_images, hist_pano_images,
                                       ob_images)
        return self.head_model.forward_sar(
            txt_ids, txt_masks, h, hist_ang_fts, hp, hist_pano_ang_fts,
            hist_masks, ob, ob_ang_fts, ob_nav_types, ob_masks,
            ob_act_angles, ob_progress, rng)

    def forward_sprel(self, txt_ids, txt_masks, hist_images, hist_ang_fts,
                      hist_pano_images, hist_pano_ang_fts, hist_masks,
                      ob_images, ob_ang_fts, ob_nav_types, ob_masks,
                      sp_anchor_idxs, sp_targets, rng=None):
        """SprelImageDataset (image_tasks.py:353-451)."""
        h, hp, ob = self._hist_and_obs(hist_images, hist_pano_images,
                                       ob_images)
        return self.head_model.forward_sprel(
            txt_ids, txt_masks, h, hist_ang_fts, hp, hist_pano_ang_fts,
            hist_masks, ob, ob_ang_fts, ob_nav_types, ob_masks,
            sp_anchor_idxs, sp_targets, rng)

    def forward_mrc(self, txt_ids, txt_masks, hist_images, hist_ang_fts,
                    hist_pano_images, hist_pano_ang_fts, hist_masks,
                    hist_mrc_masks, hist_img_probs, rng=None):
        """MrcImageDataset (image_tasks.py:81-155): the masked steps'
        backbone features are zeroed (image_vilmodel.py:83-85)."""
        h, hp, _ = self._hist_and_obs(hist_images, hist_pano_images)
        m = hist_mrc_masks[..., None]
        h = torch.where(m, torch.zeros((), device=h.device), h)
        hp = torch.where(m[..., None], torch.zeros((), device=hp.device), hp)
        return self.head_model.forward_mrc(
            txt_ids, txt_masks, h, hist_ang_fts, hp, hist_pano_ang_fts,
            hist_masks, hist_mrc_masks, hist_img_probs, rng)

    def forward_itm(self, txt_ids, txt_masks, hist_images, hist_ang_fts,
                    hist_pano_images, hist_pano_ang_fts, hist_masks,
                    neg_idxs, shuffled_pos_ids, rng=None):
        """ItmImageDataset (image_tasks.py:452-508, image_vilmodel.py:
        125-208)."""
        h, hp, _ = self._hist_and_obs(hist_images, hist_pano_images)
        return self.head_model.forward_itm(
            txt_ids, txt_masks, h, hist_ang_fts, hp, hist_pano_ang_fts,
            hist_masks, neg_idxs, shuffled_pos_ids, rng)
