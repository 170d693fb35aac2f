"""Plain float32 building blocks of the benchmark's references.

Functional BERT / LXMERT blocks over a flat dict of parameters `P` keyed
by the reference checkpoints' torch names (the names the program's modules
load under), in float32 with TF32 off: exact erf GELU, post-LN residuals
with LayerNorm eps 1e-12, additive masks (0 valid, -10000 padding),
softmax attention over [B, heads, Lq, Lk].  No kernel, cache or batching
trick: one item's result never depends on another item of the block.

`Numerics` decides how a linear layer multiplies.  float32 is the
reference; 'fp8' rounds both operands of every linear layer to float8
e4m3 with one scale per tensor (amax / 448) before the float32 product,
the step below the configurations' bfloat16 that a later change could
take: it is the control that the comparison has to reject.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_MASK = -10000.0
LOGIT_NEG = -1e9
FP8_MAX = 448.0


class Numerics:
    """How the reference's linear layers multiply: 'float32' or 'fp8'."""

    def __init__(self, mode: str = "float32"):
        if mode not in ("float32", "fp8"):
            raise ValueError(mode)
        self.mode = mode

    def matmul_weight(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w.T in the mode's precision, float32 out."""
        if self.mode == "fp8":
            x, w = fp8_round(x), fp8_round(w)
        return F.linear(x, w)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale, back in f32."""
    scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def f32_setup() -> None:
    """float32 matmuls without TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def linear(P, name: str, x, num: Numerics):
    y = num.matmul_weight(x, P[name + ".weight"])
    b = P.get(name + ".bias")
    return y if b is None else y + b


def layer_norm(P, name: str, x, eps: float = 1e-12):
    w = P[name + ".weight"]
    return F.layer_norm(x, w.shape, w, P[name + ".bias"], eps=eps)


def ext_mask(valid: torch.Tensor) -> torch.Tensor:
    """[B, L] bool -> [B, 1, 1, L] additive mask."""
    return (1.0 - valid.float())[:, None, None, :] * NEG_MASK


def softmax_attention(q, k, v, mask, heads: int):
    """softmax(q k^T / sqrt(D) + mask) v over [B, L, H] projections."""
    B, Lq, H = q.shape
    D = H // heads

    def split(t):
        return t.reshape(B, t.shape[1], heads, D).transpose(1, 2)

    s = split(q) @ split(k).transpose(-1, -2) / math.sqrt(D) + mask
    out = torch.softmax(s, dim=-1) @ split(v)
    return out.transpose(1, 2).reshape(B, Lq, H)


def attention(P, name: str, x, ctx, mask, heads: int, num: Numerics, bias=None):
    """Multi-head attention of x over ctx with `name`.{query,key,value};
    an additive `bias` [B, 1, Lq, Lk] joins the mask."""
    if bias is not None:
        mask = mask + bias
    return softmax_attention(linear(P, name + ".query", x, num),
                             linear(P, name + ".key", ctx, num),
                             linear(P, name + ".value", ctx, num), mask, heads)


def self_output(P, name: str, h, residual, num):
    return layer_norm(P, name + ".LayerNorm",
                      linear(P, name + ".dense", h, num) + residual)


def bert_attention(P, name: str, x, mask, heads, num, bias=None):
    """BertAttention: self-attention, dense, LN(x + residual)."""
    h = attention(P, name + ".self", x, x, mask, heads, num, bias)
    return self_output(P, name + ".output", h, x, num)


def x_attention(P, name: str, x, ctx, mask, heads, num):
    """BertXAttention: cross-attention of x over ctx, dense, LN."""
    h = attention(P, name + ".att", x, ctx, mask, heads, num)
    return self_output(P, name + ".output", h, x, num)


def ffn(P, inter: str, out: str, x, num):
    h = F.gelu(linear(P, inter + ".dense", x, num))
    return layer_norm(P, out + ".LayerNorm", linear(P, out + ".dense", h, num) + x)


def bert_layer(P, name: str, x, mask, heads, num):
    a = bert_attention(P, name + ".attention", x, mask, heads, num)
    return ffn(P, name + ".intermediate", name + ".output", a, num)


def angle_feature(heading, elevation):
    """[sin h, cos h, sin e, cos e]."""
    heading, elevation = torch.broadcast_tensors(heading, elevation)
    return torch.stack([torch.sin(heading), torch.cos(heading),
                        torch.sin(elevation), torch.cos(elevation)], dim=-1)


def view_heading(view, views: int):
    per_row = views // 3
    return (view % per_row) * (2.0 * math.pi / per_row)


def view_elevation(view, views: int):
    per_row = views // 3
    return (view // per_row - 1) * math.radians(30.0)


def snap_view(heading, views: int):
    """A start heading snapped onto the horizon row's nearest view."""
    per_row = views // 3
    col = torch.round(heading / (2.0 * math.pi / per_row)).long() % per_row
    return per_row + col


# ---------------------------------------------------------------- weights

class Specs(dict):
    """name -> (shape, family), in the order the model declares them."""

    def linear(self, name: str, n_in: int, n_out: int, bias: bool = True):
        self[name + ".weight"] = ((n_out, n_in), "linear")
        if bias:
            self[name + ".bias"] = ((n_out,), "bias")

    def norm(self, name: str, dim: int):
        self[name + ".weight"] = ((dim,), "ln_w")
        self[name + ".bias"] = ((dim,), "bias")

    def embed(self, name: str, num: int, dim: int):
        self[name + ".weight"] = ((num, dim), "embed")


def draw_weights(specs: Specs, seed: int, device) -> dict:
    """Every parameter of `specs` from `seed`, on `device`: one N(0, 1)
    draw for all of them, then each slice scaled by its family (linear
    weights 1 / sqrt(fan_in), embeddings 1 / sqrt(dim), LayerNorm gains
    1 + 0.02 n, biases and tokens 0.02 n)."""
    total = sum(math.prod(s) for s, _ in specs.values())
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 7919 + 17) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, kind) in specs.items():
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if kind == "linear":
            x = x * (1.0 / math.sqrt(shape[1]))
        elif kind == "embed":
            x = x * (1.0 / math.sqrt(shape[-1]))
        elif kind == "ln_w":
            x = 1.0 + 0.02 * x
        else:
            x = 0.02 * x
        out[name] = x
    return out
