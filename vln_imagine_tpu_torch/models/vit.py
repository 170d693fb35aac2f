"""Vision Transformer (ViT-B/16) in PyTorch, for feature extraction and for
the ViT in the training loop.

The port of `vln_imagine_tpu/models/vit.py` (a rebuild of the vendored timm
ViT, VLN-HAMT/pretrain_src/model/vision_transformer.py:135-720).  It is used
three ways: offline, to embed panorama views and imagination images
(`FeatureExtractor`, `scripts/extract_features.py`); inside the navigators
under `e2e_imagination` (`make_imagine_vit`, `extract_imagine_features`);
and inside E2E pre-training (`pretrain/hamt_e2e.py`).

Architecture (timm vit_base_patch16_224): conv patch embed, prepended class
token, learned position embeddings, pre-norm blocks (LayerNorm eps 1e-6,
exact-erf GELU), final LayerNorm; the class token's final embedding is the
feature.  Module and parameter names are timm's, so a timm state_dict loads
with `load_state_dict` (`ckpt/convert.py:vit_torch_to_flax_path` maps them
to the JAX package's flax paths).

Numerics follow the JAX package: parameters in f32, the residual stream in
the compute dtype (only the LayerNorms run in f32), the class token and
position embeddings cast to the compute dtype before the add, and the final
LayerNorm's output in f32.  Attention goes through
`ops/attention.py:fused_attention` (K1 forward, K4 backward on the card):
f32 scores and softmax, P rounded to the compute dtype, f32 accumulation,
as the JAX block's einsums.  Images keep the JAX layout [..., H, W, 3] at
the API; the patch conv permutes to NCHW inside.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vln_imagine_tpu_torch.models.bert import Dense, LayerNormF32, gelu_erf
from vln_imagine_tpu_torch.ops.attention import fused_attention


class ViTConfig:
    def __init__(self, image_size=224, patch_size=16, hidden_size=768,
                 num_layers=12, num_heads=12, mlp_ratio=4.0,
                 compute_dtype="bfloat16"):
        self.image_size = image_size
        self.patch_size = patch_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_dim = int(hidden_size * mlp_ratio)
        self.compute_dtype = compute_dtype
        self.num_patches = (image_size // patch_size) ** 2

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


class Attention(nn.Module):
    """timm's Attention: one packed qkv projection, then `proj`."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        dt = cfg.dtype
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv = Dense(cfg.hidden_size, 3 * cfg.hidden_size, dt)
        self.proj = Dense(cfg.hidden_size, cfg.hidden_size, dt)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        # [B, L, 3, H, D]: q, k and v are strided views the kernel reads
        qkv = self.qkv(h).unflatten(-1, (3, self.num_heads, self.head_dim))
        ctx = fused_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], None,
                              1.0 / math.sqrt(self.head_dim))
        return self.proj(ctx.flatten(2))


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.fc1 = Dense(cfg.hidden_size, cfg.mlp_dim, cfg.dtype)
        self.fc2 = Dense(cfg.mlp_dim, cfg.hidden_size, cfg.dtype)

    def forward(self, h):
        return self.fc2(gelu_erf(self.fc1(h)))


class Block(nn.Module):
    """Pre-norm block: x + attn(LN(x)), then x + mlp(LN(x)), with x in the
    compute dtype and the LayerNorms in f32."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = LayerNormF32(cfg.hidden_size, 1e-6)
        self.attn = Attention(cfg)
        self.norm2 = LayerNormF32(cfg.hidden_size, 1e-6)
        self.mlp = Mlp(cfg)
        self.dtype = cfg.dtype

    def forward(self, x):
        x = x + self.attn(self.norm1(x).to(self.dtype))
        return x + self.mlp(self.norm2(x).to(self.dtype))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.hidden_size, p, stride=p)
        self.dtype = cfg.dtype

    def forward(self, images):
        """[B, H, W, 3] -> [B, P, hidden] in the compute dtype, patches in
        row-major order (as the flax NHWC conv's reshape)."""
        dt = self.dtype
        x = F.conv2d(images.to(dt).permute(0, 3, 1, 2),
                     self.proj.weight.to(dt), self.proj.bias.to(dt),
                     stride=self.proj.stride)
        return x.flatten(2).transpose(1, 2)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig | None = None):
        super().__init__()
        cfg = cfg or ViTConfig()
        self.cfg = cfg
        H = cfg.hidden_size
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, H))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.num_patches, H))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.norm = LayerNormF32(H, 1e-6)

    def forward(self, images: torch.Tensor):
        """images [B, H, W, 3], already normalised -> (class-token feature
        [B, D] f32, tokens [B, 1 + P, D] f32)."""
        dt = self.cfg.dtype
        x = self.patch_embed(images)
        B = x.shape[0]
        cls = self.cls_token.to(dt).expand(B, 1, -1)
        x = torch.cat([cls, x], 1) + self.pos_embed.to(dt)
        for block in self.blocks:
            x = block(x)
        x = F.layer_norm(x.float(), self.norm.weight.shape, self.norm.weight,
                         self.norm.bias, eps=self.norm.eps)
        return x[:, 0], x


def make_imagine_vit(model_cfg) -> VisionTransformer:
    """The navigator's ViT under `e2e_imagination`: its hidden size is the
    navigator's, so the class token feeds the imagination embeddings
    directly."""
    if model_cfg.hidden_size % model_cfg.e2e_vit_heads:
        raise ValueError(f"e2e_vit_heads={model_cfg.e2e_vit_heads} must "
                         f"divide hidden_size={model_cfg.hidden_size}")
    return VisionTransformer(ViTConfig(
        image_size=model_cfg.e2e_vit_image_size,
        patch_size=model_cfg.e2e_vit_patch_size,
        hidden_size=model_cfg.hidden_size,
        num_layers=model_cfg.e2e_vit_layers,
        num_heads=model_cfg.e2e_vit_heads,
        compute_dtype=model_cfg.compute_dtype))


def extract_imagine_features(vit: VisionTransformer, images, model_cfg
                             ) -> torch.Tensor:
    """[B, I, Hp, Wp, 3] preprocessed images -> [B, I, H] f32 class-token
    features.  Under 'frozen' the ViT runs without autograd, so the backward
    skips it and keeps none of its activations (the JAX package's
    `stop_gradient`)."""
    B, I = images.shape[:2]
    frozen = model_cfg.e2e_imagination == "frozen"
    with torch.no_grad() if frozen else contextlib.nullcontext():
        cls, _ = vit(images.reshape((B * I,) + tuple(images.shape[2:])))
    return cls.reshape(B, I, -1).float()


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess(images_uint8: np.ndarray) -> np.ndarray:
    """[., H, W, 3] uint8 -> normalised float32 (timm's default transform)."""
    x = images_uint8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


class FeatureExtractor:
    """Batched ViT feature extraction for panoramas and imagination images,
    on `device` (the card unless the caller names one)."""

    def __init__(self, model: VisionTransformer, batch_size: int = 64,
                 device=None):
        from vln_imagine_tpu_torch.platform import resolve_device

        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.batch_size = batch_size

    @classmethod
    def random_init(cls, generator: torch.Generator | None = None,
                    cfg: ViTConfig | None = None, **kw) -> "FeatureExtractor":
        """Seeded random weights (flax's initializers; pipeline smoke runs
        only)."""
        from vln_imagine_tpu_torch.train.trainer import init_params

        model = VisionTransformer(cfg)
        init_params(model, generator if generator is not None
                    else torch.Generator().manual_seed(0))
        return cls(model, **kw)

    @torch.no_grad()
    def extract(self, images: np.ndarray) -> np.ndarray:
        """[N, H, W, 3] preprocessed -> [N, D] f32 class-token features, in
        batches of `batch_size` to bound device memory."""
        outs = []
        for i in range(0, len(images), self.batch_size):
            chunk = torch.as_tensor(np.asarray(images[i: i + self.batch_size],
                                               np.float32), device=self.device)
            outs.append(self.model(chunk)[0].cpu().numpy())
        return np.concatenate(outs, 0) if outs else np.zeros(
            (0, self.cfg.hidden_size), np.float32)

    def extract_panoramas(self, pano_images: np.ndarray) -> np.ndarray:
        """[N_nodes, V, H, W, 3] -> [N_nodes, V, D]."""
        n, v = pano_images.shape[:2]
        flat = pano_images.reshape((n * v,) + pano_images.shape[2:])
        return self.extract(flat).reshape(n, v, -1)
