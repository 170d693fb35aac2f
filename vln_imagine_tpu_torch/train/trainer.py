"""HAMT trainer, eval half: model construction, seeded init, greedy eval.

The port of `vln_imagine_tpu/train/trainer.py:HamtTrainer`.  The model holds
its parameters, so the eval step takes only the episodes.  The train step
waits for the training slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vln_imagine_tpu_torch.config import Config
from vln_imagine_tpu_torch.envx.tables import WorldTables
from vln_imagine_tpu_torch.models.bert import LayerNorm12
from vln_imagine_tpu_torch.models.hamt import HamtModel
from vln_imagine_tpu_torch.platform import resolve_device
from vln_imagine_tpu_torch.train.rollout_hamt import make_eval_fn

# flax's lecun_normal: a normal truncated at +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers, drawn from `generator` in module order:
    Dense kernels lecun_normal, biases 0, embeddings N(0, 1/dim), LayerNorm
    1 and 0, the history [CLS] token 0."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            std = 1.0 / math.sqrt(mod.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.embedding_dim),
                               generator=generator)
        elif isinstance(mod, LayerNorm12):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith("cls_token"):
            p.zero_()


class HamtTrainer:
    """Builds the HAMT model with seeded weights on `device` (the card unless
    the caller names one) and the greedy eval step over `tables`."""

    def __init__(self, cfg: Config, tables: WorldTables, device=None,
                 seed: int | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(
            cfg.train.seed if seed is None else seed)
        model = HamtModel(cfg.model)
        init_params(model, gen)  # on the CPU: the same weights on any device
        self.model = model.to(self.device).eval()
        self.tables = tables.to(self.device)

    def make_eval_step(self):
        """episodes -> (path_nodes, path_len), greedy with early exit."""
        return make_eval_fn(self.model, self.tables, self.cfg, self.device)
