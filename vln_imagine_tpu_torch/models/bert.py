"""BERT / LXMERT transformer blocks in PyTorch, numerically matching the
JAX package's flax blocks and the reference's torch blocks
(VLN-HAMT/finetune_src/models/vilmodel_cmt.py:44-520):

- exact erf GELU (vilmodel_cmt.py:27-33)
- LayerNorm eps 1e-12, post-LN residual blocks, computed in f32
- additive attention masks, 0 for valid / -10000 for padding
- parameters in f32; matmuls and attention in `ModelConfig.compute_dtype`

Module and parameter names are the reference's torch key names, so a
released state_dict loads with `load_state_dict` (see ckpt/convert.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vln_imagine_tpu_torch.config import ModelConfig
from vln_imagine_tpu_torch.ops.attention import fused_attention


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """x * 0.5 * (1 + erf(x / sqrt(2))): the reference's gelu, not the tanh
    approximation."""
    return F.gelu(x, approximate="none")


ACT2FN = {"gelu": gelu_erf, "gelu_erf": gelu_erf, "relu": F.relu,
          "swish": F.silu}


def _cast_cached(module: nn.Module, tensors, dtype: torch.dtype, pack=None):
    """Parameters cast to the compute dtype (optionally packed into one).

    Without autograd the cast copy is kept on the module until a parameter
    changes (in-place update, `load_state_dict`, `.to`), so an eval rollout
    casts every weight once, not once per step; with autograd it is recast
    on every call so gradients reach the f32 parameters."""
    def build():
        out = [t.to(dtype) for t in tensors]
        return pack(out) if pack is not None else out
    if torch.is_grad_enabled():
        return build()
    key = (dtype,) + tuple((id(t), t.data_ptr(), t._version) for t in tensors)
    cache = module.__dict__.get("_cast_cache")
    if cache is None or cache[0] != key:
        cache = (key, build())
        module.__dict__["_cast_cache"] = cache
    return cache[1]


class Dense(nn.Linear):
    """nn.Linear with f32 parameters that computes in the compute dtype,
    as flax `Dense(dtype=...)`: input and parameters are cast first."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = [self.weight] if self.bias is None else [self.weight, self.bias]
        cast = _cast_cached(self, params, self.compute_dtype)
        return F.linear(x.to(self.compute_dtype), cast[0],
                        cast[1] if len(cast) > 1 else None)


class Embed(nn.Embedding):
    """nn.Embedding whose lookup comes out in the compute dtype."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype):
        super().__init__(num, dim)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.weight).to(self.compute_dtype)


class LayerNorm12(nn.Module):
    """LayerNorm with eps 1e-12, computed in float32, output in x's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.layer_norm(x.float(), self.weight.shape, self.weight,
                           self.bias, eps=1e-12)
        return out.to(x.dtype)


class MHAttention(nn.Module):
    """Q/K/V projection + attention.  The context (key/value source) may
    differ from the query stream (BertOutAttention, vilmodel_cmt.py:302-353).

    The projections are packed into one (self-attention) or two
    (cross-attention) wide matmuls; q, k and v are then strided views of the
    packed product in [B, L, H, D] layout, which the attention kernel reads
    in place."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        H, dt = cfg.hidden_size, compute_dtype(cfg)
        self.num_heads, self.head_dim = cfg.num_attention_heads, cfg.head_dim
        self.compute_dtype = dt
        self.query = Dense(H, H, dt)
        self.key = Dense(H, H, dt)
        self.value = Dense(H, H, dt)

    def forward(self, hidden: torch.Tensor, context: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
        dt = self.compute_dtype
        q_, k_, v_ = self.query, self.key, self.value
        if hidden is context:
            w, b = _cast_cached(
                self, [q_.weight, k_.weight, v_.weight, q_.bias, k_.bias,
                       v_.bias], dt,
                pack=lambda t: (torch.cat(t[:3]), torch.cat(t[3:])))
            q, k, v = F.linear(hidden.to(dt), w, b).split(q_.out_features, -1)
        else:
            q = q_(hidden)
            w, b = _cast_cached(
                self, [k_.weight, v_.weight, k_.bias, v_.bias], dt,
                pack=lambda t: (torch.cat(t[:2]), torch.cat(t[2:])))
            k, v = F.linear(context.to(dt), w, b).split(k_.out_features, -1)

        def heads(x):
            return x.unflatten(-1, (self.num_heads, self.head_dim))

        ctx = fused_attention(heads(q), heads(k), heads(v), bias,
                              1.0 / self.head_dim ** 0.5)
        return ctx.flatten(2)


class SelfOutput(nn.Module):
    """dense -> dropout -> LN(x + residual) (BertSelfOutput, :137-148)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size, compute_dtype(cfg))
        self.LayerNorm = LayerNorm12(cfg.hidden_size)

    def forward(self, hidden, residual):
        return self.LayerNorm(self.dense(hidden) + residual)


class BertAttention(nn.Module):
    """Self-attention block (BertAttention, :151-161)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.self = MHAttention(cfg)
        self.output = SelfOutput(cfg)

    def forward(self, x, mask):
        return self.output(self.self(x, x, mask), x)


class BertXAttention(nn.Module):
    """Cross-attention block (BertXAttention, :355-364)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.att = MHAttention(cfg)
        self.output = SelfOutput(cfg)

    def forward(self, x, ctx, ctx_mask=None):
        return self.output(self.att(x, ctx, ctx_mask), x)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.intermediate_size,
                           compute_dtype(cfg))
        self.act = ACT2FN[cfg.hidden_act]

    def forward(self, x):
        return self.act(self.dense(x))


class BertOutput(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.dense = Dense(cfg.intermediate_size, cfg.hidden_size,
                           compute_dtype(cfg))
        self.LayerNorm = LayerNorm12(cfg.hidden_size)

    def forward(self, x, residual):
        return self.LayerNorm(self.dense(x) + residual)


class BertLayer(nn.Module):
    """attention -> intermediate -> output (BertLayer, :193-206)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, x, mask):
        attn = self.attention(x, mask)
        return self.output(self.intermediate(attn), attn)


class BertEncoder(nn.Module):
    """Stack of BertLayer (BertEncoder, :209-239)."""

    def __init__(self, cfg: ModelConfig, num_layers: int):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(num_layers))

    def forward(self, x, mask):
        for layer in self.layer:
            x = layer(x, mask)
        return x


class BertEmbeddings(nn.Module):
    """word + position + token-type embeddings -> LN
    (BertEmbeddings, :44-73; dropout is the identity in eval)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, dt)
        self.position_embeddings = Embed(cfg.max_position_embeddings,
                                         cfg.hidden_size, dt)
        self.token_type_embeddings = Embed(cfg.type_vocab_size,
                                           cfg.hidden_size, dt)
        self.LayerNorm = LayerNorm12(cfg.hidden_size)

    def forward(self, input_ids):
        L = input_ids.shape[1]
        position_ids = torch.arange(L, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return self.LayerNorm(x)


class LXRTXLayer(nn.Module):
    """HAMT bidirectional cross-modal layer (vilmodel_cmt.py:366-445):
    shared cross-attention applied both ways, then per-stream self-attention
    and FFN."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.no_lang_ca:
            raise NotImplementedError("no_lang_ca is not ported yet")
        self.visual_attention = BertXAttention(cfg)
        self.lang_self_att = BertAttention(cfg)
        self.lang_inter = BertIntermediate(cfg)
        self.lang_output = BertOutput(cfg)
        self.visn_self_att = BertAttention(cfg)
        self.visn_inter = BertIntermediate(cfg)
        self.visn_output = BertOutput(cfg)

    def forward(self, lang, lang_mask, visn, visn_mask):
        lang_x = self.visual_attention(lang, visn, visn_mask)
        visn_x = self.visual_attention(visn, lang, lang_mask)
        lang_s = self.lang_self_att(lang_x, lang_mask)
        visn_s = self.visn_self_att(visn_x, visn_mask)
        lang_o = self.lang_output(self.lang_inter(lang_s), lang_s)
        visn_o = self.visn_output(self.visn_inter(visn_s), visn_s)
        return lang_o, visn_o


class NextActionPrediction(nn.Module):
    """Linear -> ReLU -> LN -> Dropout -> Linear(1) (vilmodel_cmt.py:953-963);
    `net.{0,2,4}` are the reference's Sequential indices."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        self.net = nn.Sequential(
            Dense(cfg.hidden_size, cfg.hidden_size, dt), nn.ReLU(),
            LayerNorm12(cfg.hidden_size), nn.Dropout(cfg.pred_head_dropout_prob),
            Dense(cfg.hidden_size, 1, dt))

    def forward(self, x):
        return self.net(x)


class MLPProjectionHead(nn.Module):
    """768 -> 512 -> 512 -> hidden, bias-free, ReLU
    (vilmodel_cmt.py:714-728; its dropout is the identity in eval)."""

    def __init__(self, cfg: ModelConfig, hidden_dim: int = 512):
        super().__init__()
        dt = compute_dtype(cfg)
        self.fc1 = Dense(cfg.hidden_size, hidden_dim, dt, bias=False)
        self.fc2 = Dense(hidden_dim, hidden_dim, dt, bias=False)
        self.fc3 = Dense(hidden_dim, cfg.hidden_size, dt, bias=False)

    def forward(self, x):
        return self.fc3(F.relu(self.fc2(F.relu(self.fc1(x)))))
