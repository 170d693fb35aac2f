"""BERT / LXMERT transformer blocks in PyTorch, numerically matching the
JAX package's flax blocks and the reference's torch blocks
(VLN-HAMT/finetune_src/models/vilmodel_cmt.py:44-520; DUET's graph
cross-modal layer and pre-norm pano encoder, VLN-DUET/map_nav_src/models/
vilmodel.py:366-412 and transformer.py:135-192):

- exact erf GELU (vilmodel_cmt.py:27-33)
- LayerNorm eps 1e-12, post-LN residual blocks, computed in f32
- additive attention masks, 0 for valid / -10000 for padding
- parameters in f32; matmuls and attention in `ModelConfig.compute_dtype`
- dropout at the flax blocks' sites, drawn from an explicit `Rng`
  (ops/dropout.py); `rng=None` is flax's `deterministic=True`

Module and parameter names are the reference's torch key names, so a
released state_dict loads with `load_state_dict` (see ckpt/convert.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vln_imagine_tpu_torch.config import ModelConfig
from vln_imagine_tpu_torch.ops.attention import fused_attention
from vln_imagine_tpu_torch.ops.dropout import Rng, dropout


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


class LayerNormF32(nn.Module):
    """LayerNorm computed in float32, output in x's dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.layer_norm(x.float(), self.weight.shape, self.weight,
                           self.bias, eps=self.eps)
        return out.to(x.dtype)


class LayerNorm12(LayerNormF32):
    """The BERT blocks' LayerNorm: eps 1e-12."""

    def __init__(self, dim: int):
        super().__init__(dim, 1e-12)


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
        self.probs_dropout = cfg.attention_probs_dropout_prob
        self.query = Dense(H, H, dt)
        self.key = Dense(H, H, dt)
        self.value = Dense(H, H, dt)

    def forward(self, hidden: torch.Tensor, context: torch.Tensor,
                bias: torch.Tensor | None = None,
                rng: Rng | None = None) -> torch.Tensor:
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

        rate = self.probs_dropout if rng is not None else 0.0
        ctx = fused_attention(heads(q), heads(k), heads(v), bias,
                              1.0 / self.head_dim ** 0.5, dropout_rate=rate,
                              seed=rng.seed() if rate > 0.0 else None)
        return ctx.flatten(2)


class SelfOutput(nn.Module):
    """dense -> dropout -> LN(x + residual) (BertSelfOutput, :137-148)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size, compute_dtype(cfg))
        self.LayerNorm = LayerNorm12(cfg.hidden_size)
        self.rate = cfg.hidden_dropout_prob

    def forward(self, hidden, residual, rng=None):
        return self.LayerNorm(dropout(self.dense(hidden), self.rate, rng)
                              + residual)


class BertAttention(nn.Module):
    """Self-attention block (BertAttention, :151-161).  An additive `bias`
    (DUET's graph_sprels, [B, 1, L, L]) is added to the mask
    (vilmodel.py:392-394)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.self = MHAttention(cfg)
        self.output = SelfOutput(cfg)

    def forward(self, x, mask, rng=None, bias=None):
        if bias is not None:
            mask = mask + bias
        return self.output(self.self(x, x, mask, rng), x, rng)


class BertXAttention(nn.Module):
    """Cross-attention block (BertXAttention, :355-364)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.att = MHAttention(cfg)
        self.output = SelfOutput(cfg)

    def forward(self, x, ctx, ctx_mask=None, rng=None):
        return self.output(self.att(x, ctx, ctx_mask, rng), x, rng)


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
        self.rate = cfg.hidden_dropout_prob

    def forward(self, x, residual, rng=None):
        return self.LayerNorm(dropout(self.dense(x), self.rate, rng) + residual)


class BertLayer(nn.Module):
    """attention -> intermediate -> output (BertLayer, :193-206)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, x, mask, rng=None):
        attn = self.attention(x, mask, rng)
        return self.output(self.intermediate(attn), attn, rng)


class BertEncoder(nn.Module):
    """Stack of BertLayer (BertEncoder, :209-239)."""

    def __init__(self, cfg: ModelConfig, num_layers: int):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(num_layers))

    def forward(self, x, mask, rng=None):
        for layer in self.layer:
            x = layer(x, mask, rng)
        return x


class BertEmbeddings(nn.Module):
    """word + position + token-type embeddings -> LN -> dropout
    (BertEmbeddings, :44-73)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, dt)
        self.position_embeddings = Embed(cfg.max_position_embeddings,
                                         cfg.hidden_size, dt)
        self.token_type_embeddings = Embed(cfg.type_vocab_size,
                                           cfg.hidden_size, dt)
        self.LayerNorm = LayerNorm12(cfg.hidden_size)
        self.rate = cfg.hidden_dropout_prob

    def forward(self, input_ids, rng=None):
        L = input_ids.shape[1]
        position_ids = torch.arange(L, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return dropout(self.LayerNorm(x), self.rate, rng)

    def token_type_embedding(self, token_type_ids):
        """The token-type lookup alone, which the image embeddings add
        (vilmodel_cmt.py:1074-1076)."""
        return self.token_type_embeddings(token_type_ids)


class LXRTXLayer(nn.Module):
    """HAMT bidirectional cross-modal layer (vilmodel_cmt.py:366-445):
    shared cross-attention applied both ways, then per-stream self-attention
    and FFN.  Under no_lang_ca the language stream passes through unchanged;
    its blocks then run only in `lang_self_att_branch`, which the language
    mode calls (vilmodel_cmt.py:1024-1028)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.no_lang_ca = cfg.no_lang_ca
        self.visual_attention = BertXAttention(cfg)
        self.lang_self_att = BertAttention(cfg)
        self.lang_inter = BertIntermediate(cfg)
        self.lang_output = BertOutput(cfg)
        self.visn_self_att = BertAttention(cfg)
        self.visn_inter = BertIntermediate(cfg)
        self.visn_output = BertOutput(cfg)

    def forward(self, lang, lang_mask, visn, visn_mask, rng=None):
        if self.no_lang_ca:
            visn_x = self.visual_attention(visn, lang, lang_mask, rng)
            visn_s = self.visn_self_att(visn_x, visn_mask, rng)
            return lang, self.visn_output(self.visn_inter(visn_s), visn_s, rng)
        lang_x = self.visual_attention(lang, visn, visn_mask, rng)
        visn_x = self.visual_attention(visn, lang, lang_mask, rng)
        lang_s = self.lang_self_att(lang_x, lang_mask, rng)
        visn_s = self.visn_self_att(visn_x, visn_mask, rng)
        lang_o = self.lang_output(self.lang_inter(lang_s), lang_s, rng)
        visn_o = self.visn_output(self.visn_inter(visn_s), visn_s, rng)
        return lang_o, visn_o

    def lang_self_att_branch(self, lang, lang_mask, rng=None):
        """The language self-attention + FFN alone (no_lang_ca)."""
        s = self.lang_self_att(lang, lang_mask, rng)
        return self.lang_output(self.lang_inter(s), s, rng)


class GraphLXRTXLayer(nn.Module):
    """DUET cross-modal layer (vilmodel.py:366-412): the visual stream
    queries the language, then graph-biased self-attention + FFN; and, in
    pre-training's MLM, the other direction (`lang2visn`): the language
    queries the visual stream through the same `visual_attention`, then
    language self-attention + FFN.

    flax creates a block's parameters at its first use, so the JAX
    package's layer holds only the blocks its forwards reach: `lang` builds
    the language-side blocks (pre-training with MLM), `visn` the
    visual-side ones (every forward but MLM's).  The navigator has no
    language side whatever `use_lang2visn_attn` says."""

    def __init__(self, cfg: ModelConfig, lang: bool = False,
                 visn: bool = True):
        super().__init__()
        self.visual_attention = BertXAttention(cfg)
        if visn:
            self.visn_self_att = BertAttention(cfg)
            self.visn_inter = BertIntermediate(cfg)
            self.visn_output = BertOutput(cfg)
        if lang:
            self.lang_self_att = BertAttention(cfg)
            self.lang_inter = BertIntermediate(cfg)
            self.lang_output = BertOutput(cfg)

    def forward(self, lang, lang_mask, visn, visn_mask, graph_sprels=None,
                rng=None):
        visn_x = self.visual_attention(visn, lang, lang_mask, rng)
        visn_s = self.visn_self_att(visn_x, visn_mask, rng, bias=graph_sprels)
        return self.visn_output(self.visn_inter(visn_s), visn_s, rng)

    def lang2visn(self, lang, lang_mask, visn, visn_mask, rng=None):
        """forward_lang2visn (vilmodel.py:401-412)."""
        lang_x = self.visual_attention(lang, visn, visn_mask, rng)
        lang_s = self.lang_self_att(lang_x, lang_mask, rng)
        return self.lang_output(self.lang_inter(lang_s), lang_s, rng)


class PackedSelfAttention(nn.Module):
    """Self-attention with torch nn.MultiheadAttention's parameters
    (`in_proj_weight` [3H, H] = the query, key and value projections
    stacked, `in_proj_bias`, `out_proj`), computed as the JAX package's
    MHAttention + out_proj Dense: one packed QKV matmul, the attention
    kernel, the output projection."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        H, dt = cfg.hidden_size, compute_dtype(cfg)
        self.num_heads, self.head_dim = cfg.num_attention_heads, cfg.head_dim
        self.compute_dtype = dt
        self.probs_dropout = cfg.attention_probs_dropout_prob
        self.in_proj_weight = nn.Parameter(torch.empty(3 * H, H))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * H))
        self.out_proj = Dense(H, H, dt)

    def forward(self, x, bias, rng=None):
        w, b = _cast_cached(self, [self.in_proj_weight, self.in_proj_bias],
                            self.compute_dtype)
        q, k, v = (t.unflatten(-1, (self.num_heads, self.head_dim)) for t in
                   F.linear(x.to(self.compute_dtype), w, b).chunk(3, dim=-1))
        rate = self.probs_dropout if rng is not None else 0.0
        ctx = fused_attention(q, k, v, bias, 1.0 / self.head_dim ** 0.5,
                              dropout_rate=rate,
                              seed=rng.seed() if rate > 0.0 else None)
        return self.out_proj(ctx.flatten(2))


class PreNormEncoderLayer(nn.Module):
    """DETR-style pre-norm transformer encoder layer
    (VLN-DUET/map_nav_src/models/transformer.py:135-192, forward_pre with
    gelu, ops.py:11-23): LayerNorm eps 1e-5 in f32, key padding as a -1e9
    additive bias."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        H, dt = cfg.hidden_size, compute_dtype(cfg)
        self.self_attn = PackedSelfAttention(cfg)
        self.linear1 = Dense(H, cfg.intermediate_size, dt)
        self.linear2 = Dense(cfg.intermediate_size, H, dt)
        self.norm1 = LayerNormF32(H, 1e-5)
        self.norm2 = LayerNormF32(H, 1e-5)
        self.act = ACT2FN[cfg.hidden_act]
        self.rate = cfg.hidden_dropout_prob

    def forward(self, src, key_padding_mask, rng=None):
        # key_padding_mask: True = valid
        bias = torch.where(key_padding_mask[:, None, None, :], 0.0, -1e9)
        src = src + dropout(self.self_attn(self.norm1(src), bias, rng),
                            self.rate, rng)
        ff = dropout(self.act(self.linear1(self.norm2(src))), self.rate, rng)
        return src + dropout(self.linear2(ff), self.rate, rng)


class PreNormEncoder(nn.Module):
    """Stack of pre-norm layers and a final LayerNorm (eps 1e-12;
    create_transformer_encoder, ops.py:11-23)."""

    def __init__(self, cfg: ModelConfig, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(PreNormEncoderLayer(cfg)
                                    for _ in range(num_layers))
        self.norm = LayerNorm12(cfg.hidden_size)

    def forward(self, src, key_padding_mask, rng=None):
        for layer in self.layers:
            src = layer(src, key_padding_mask, rng)
        return self.norm(src)


class ClsPrediction(nn.Module):
    """Linear -> ReLU -> LN -> Linear(1) (DUET vilmodel.py:1009-1020);
    `net.{0,2,3}` are the reference's Sequential indices."""

    def __init__(self, cfg: ModelConfig, input_size: int | None = None):
        super().__init__()
        H, dt = cfg.hidden_size, compute_dtype(cfg)
        self.net = nn.ModuleDict({"0": Dense(input_size or H, H, dt),
                                  "2": LayerNorm12(H),
                                  "3": Dense(H, 1, dt)})

    def forward(self, x):
        return self.net["3"](self.net["2"](F.relu(self.net["0"](x))))


class NextActionPrediction(nn.Module):
    """Linear -> ReLU -> LN -> Dropout -> Linear(1) (vilmodel_cmt.py:953-963);
    `net.{0,2,4}` are the reference's Sequential indices."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        self.net = nn.ModuleDict({
            "0": Dense(cfg.hidden_size, cfg.hidden_size, dt),
            "2": LayerNorm12(cfg.hidden_size),
            "4": Dense(cfg.hidden_size, 1, dt)})
        self.rate = cfg.pred_head_dropout_prob

    def forward(self, x, rng=None):
        x = self.net["2"](F.relu(self.net["0"](x)))
        return self.net["4"](dropout(x, self.rate, rng))


class MLPProjectionHead(nn.Module):
    """dropout 0.15 -> 768 -> 512 -> 512 -> hidden, bias-free, ReLU
    (vilmodel_cmt.py:714-728)."""

    def __init__(self, cfg: ModelConfig, hidden_dim: int = 512):
        super().__init__()
        dt = compute_dtype(cfg)
        self.fc1 = Dense(cfg.hidden_size, hidden_dim, dt, bias=False)
        self.fc2 = Dense(hidden_dim, hidden_dim, dt, bias=False)
        self.fc3 = Dense(hidden_dim, cfg.hidden_size, dt, bias=False)
        self.rate = 0.15

    def forward(self, x, rng=None):
        x = dropout(x, self.rate, rng)
        return self.fc3(F.relu(self.fc2(F.relu(self.fc1(x)))))


class Critic(nn.Module):
    """768 -> 512 -> ReLU -> dropout 0.5 -> 1 value head
    (model_HAMT.py:289-300); `state2value.{0,3}` are the reference's
    Sequential indices."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        self.state2value = nn.ModuleDict({"0": Dense(cfg.hidden_size, 512, dt),
                                          "3": Dense(512, 1, dt)})
        self.rate = 0.5

    def forward(self, state, rng=None):
        x = F.relu(self.state2value["0"](state))
        return self.state2value["3"](dropout(x, self.rate, rng))[..., 0]
