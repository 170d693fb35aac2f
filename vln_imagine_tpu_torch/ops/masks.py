"""Mask utilities.

The reference encodes padding with additive masks ``(1 - m) * -10000``
applied before softmax (VLN-HAMT/finetune_src/models/vilmodel_cmt.py:1010-1012)
and fills invalid action logits with ``-inf`` (vilmodel_cmt.py:1200).  The
exact -10000 constant is kept for checkpoint parity of attention outputs.
"""

from __future__ import annotations

import torch

NEG_INF_MASK = -10000.0
LOGIT_NEG_INF = -1e9  # stand-in for -inf in masked logits; safe under softmax


def extend_neg_mask(mask: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, L] bool/int mask -> [B, 1, 1, L] additive mask (0 valid, -10000 pad).

    The attention kernel reads it with stride 0 over heads and query rows."""
    m = mask.to(dtype)
    return (1.0 - m[:, None, None, :]) * NEG_INF_MASK


def mask_logits(logits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Fill invalid entries with a large negative value
    (reference: ``masked_fill_(-inf)``, vilmodel_cmt.py:1200)."""
    return torch.where(valid, logits, LOGIT_NEG_INF)
