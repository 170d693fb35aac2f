"""Weight bridge: the reference's torch keys <-> flax params of the JAX package.

The port's modules carry the reference's torch key names (NavCMT,
VLN-HAMT/finetune_src/models/vilmodel_cmt.py; GlocalTextPathNavCMT,
VLN-DUET/map_nav_src/models/vilmodel.py), so a released checkpoint loads
with `load_state_dict` once its `module.` / `vln_bert.` prefixes are
stripped (`strip_reference_prefixes`).  The key maps below are the port's
own copy of the HAMT and DUET rules of the JAX package's converter; on top
of them, `state_dict_from_flax` turns that package's params (a nested dict
of numpy arrays) into the port's state_dict and `flax_from_state_dict` goes
back, for either agent.

Conversion rules:
- torch nn.Linear weight [out, in]  <-> flax Dense kernel [in, out]
- torch nn.Embedding weight         <-> flax Embed embedding
- torch LayerNorm weight/bias       <-> flax LayerNorm ln/scale, ln/bias
  (DUET's pre-norm norm1/norm2: scale, bias)
- torch nn.MultiheadAttention (DUET pano encoder, transformer.py:138):
  in_proj_weight [3H, H] / in_proj_bias <-> the query/key/value Dense
  params; out_proj <-> the explicit out_proj Dense
- nn.Sequential heads map by index (NextActionPrediction net.{0,2,4},
  ClsPrediction net.{0,2,3}, the critic's state2value.{0,3} <-> fc0 / fc1:
  `critic_state_dict_from_flax`, `critic_flax_from_state_dict`)
- the ViT (timm vit_base_patch16_224 keys, `vit_torch_to_flax_path`): conv
  weight [O, I, kh, kw] <-> flax Conv kernel [kh, kw, I, O]; `cls_token`
  and `pos_embed` as they are.  Inside a navigator it sits under
  `imagine_vit`, inside E2E pre-training under `vit`
- the HAMT pre-training heads (agent "hamt_pretrain"): the MLM head as
  `mlm_head.predictions.*` (decoder tied to the word embeddings), the
  action head as the fine-tune model's `next_action`, and the other heads
  (`regress_action`, `sprel_head`, `image_classifier`, `itm_head`) under
  their flax names (dense0, LayerNorm, dense1); agent "hamt_e2e_pretrain"
  is `vit` + `head_model` (that tree)
- the DUET pre-training model (agent "duet_pretrain"): the backbone under
  `bert.` with the navigator's keys (the language-side x-layer blocks
  included), `mlm_head.predictions.*`, the SAP and OG heads as the
  navigator's, and `image_classifier` under its flax names
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch


def _seq_rules(prefix: str, out: str, mapping: dict[int, str]):
    """nn.Sequential index -> named flax submodule."""
    rules = []
    for idx, name in mapping.items():
        rules.append((rf"{prefix}\.net\.{idx}\.(weight|bias)$",
                      rf"{out}/{name}/\1"))
    return rules


_BERT_LAYER = [
    (r"attention\.self\.(query|key|value)\.(weight|bias)$",
     r"attention/self/\1/\2"),
    (r"attention\.output\.dense\.(weight|bias)$", r"attention/output/dense/\1"),
    (r"attention\.output\.LayerNorm\.(weight|bias)$",
     r"attention/output/LayerNorm/ln/\1"),
    (r"intermediate\.dense\.(weight|bias)$", r"intermediate/dense/\1"),
    (r"output\.dense\.(weight|bias)$", r"output/dense/\1"),
    (r"output\.LayerNorm\.(weight|bias)$", r"output/LayerNorm/ln/\1"),
]

_X_LAYER = [
    (r"visual_attention\.att\.(query|key|value)\.(weight|bias)$",
     r"visual_attention/att/\1/\2"),
    (r"visual_attention\.output\.dense\.(weight|bias)$",
     r"visual_attention/output/dense/\1"),
    (r"visual_attention\.output\.LayerNorm\.(weight|bias)$",
     r"visual_attention/output/LayerNorm/ln/\1"),
    (r"(lang|visn)_self_att\.self\.(query|key|value)\.(weight|bias)$",
     r"\1_self_att/self/\2/\3"),
    (r"(lang|visn)_self_att\.output\.dense\.(weight|bias)$",
     r"\1_self_att/output/dense/\2"),
    (r"(lang|visn)_self_att\.output\.LayerNorm\.(weight|bias)$",
     r"\1_self_att/output/LayerNorm/ln/\2"),
    (r"(lang|visn)_inter\.dense\.(weight|bias)$", r"\1_inter/dense/\2"),
    (r"(lang|visn)_output\.dense\.(weight|bias)$", r"\1_output/dense/\2"),
    (r"(lang|visn)_output\.LayerNorm\.(weight|bias)$",
     r"\1_output/LayerNorm/ln/\2"),
]

_EMBEDDINGS = [
    (r"^embeddings\.(word|position|token_type)_embeddings\.weight$",
     r"embeddings/\1_embeddings/embedding"),
    (r"^embeddings\.LayerNorm\.(weight|bias)$", r"embeddings/LayerNorm/ln/\1"),
]

_PRENORM_LAYER = [
    (r"self_attn\.out_proj\.(weight|bias)$", r"out_proj/\1"),
    (r"linear(1|2)\.(weight|bias)$", r"linear\1/\2"),
    (r"norm(1|2)\.(weight|bias)$", r"norm\1/\2"),
    # in_proj is split into query/key/value by the converters
]


def _apply_block(rules, key):
    for pat, repl in rules:
        m = re.search(pat, key)
        if m:
            return re.sub(pat, repl, key[m.start():])
    return None


def hamt_torch_to_flax_path(key: str) -> str | None:
    """NavCMT torch key -> flax param path (slash-separated), or None if the
    key is intentionally dropped (unused heads etc.)."""
    key = re.sub(r"^module\.", "", key)
    key = re.sub(r"^(bert|vln_bert)\.", "", key)
    if key.startswith("imagine_vit."):
        return _nested("imagine_vit", vit_torch_to_flax_path, key)

    for pat, repl in _EMBEDDINGS:
        if re.match(pat, key):
            return re.sub(pat, repl, key)

    m = re.match(r"^encoder\.layer\.(\d+)\.(.*)$", key)
    if m:
        rest = _apply_block(_BERT_LAYER, m.group(2))
        return f"lang_layer_{m.group(1)}/{rest}" if rest else None
    m = re.match(r"^encoder\.x_layers\.(\d+)\.(.*)$", key)
    if m:
        rest = _apply_block(_X_LAYER, m.group(2))
        return f"x_layer_{m.group(1)}/{rest}" if rest else None
    m = re.match(r"^encoder\.(h|r)_layers\.", key)
    if m:
        return None  # 0 layers in every released config

    m = re.match(r"^img_embeddings\.(img|ang)_linear\.(weight|bias)$", key)
    if m:
        return f"img_embeddings/{m.group(1)}_linear/{m.group(2)}"
    m = re.match(r"^img_embeddings\.(img|ang)_layer_norm\.(weight|bias)$", key)
    if m:
        return f"img_embeddings/{m.group(1)}_layer_norm/ln/{m.group(2)}"
    if key == "img_embeddings.nav_type_embedding.weight":
        return "img_embeddings/nav_type_embedding/embedding"
    m = re.match(r"^img_embeddings\.layer_norm\.(weight|bias)$", key)
    if m:
        return f"img_embeddings/layer_norm/ln/{m.group(1)}"

    if key == "hist_embeddings.cls_token":
        return "hist_embeddings/cls_token"
    m = re.match(
        r"^hist_embeddings\.(pano_img|pano_ang|img|ang)_linear\.(weight|bias)$",
        key)
    if m:
        return f"hist_embeddings/{m.group(1)}_linear/{m.group(2)}"
    m = re.match(
        r"^hist_embeddings\.(pano_img|pano_ang|img|ang)_layer_norm\.(weight|bias)$",
        key)
    if m:
        return f"hist_embeddings/{m.group(1)}_layer_norm/ln/{m.group(2)}"
    if key == "hist_embeddings.position_embeddings.weight":
        return "hist_embeddings/position_embeddings/embedding"
    if key == "hist_embeddings.type_embedding.weight":
        return "hist_embeddings/type_embedding/embedding"
    m = re.match(r"^hist_embeddings\.layer_norm\.(weight|bias)$", key)
    if m:
        return f"hist_embeddings/layer_norm/ln/{m.group(1)}"
    m = re.match(r"^hist_embeddings\.pano_encoder\.layer\.(\d+)\.(.*)$", key)
    if m:
        rest = _apply_block(_BERT_LAYER, m.group(2))
        return (f"hist_embeddings/pano_encoder/layer_{m.group(1)}/{rest}"
                if rest else None)

    if key == "imagine_embeddings.type_embedding.weight":
        return "imagine_embeddings/type_embedding/embedding"
    m = re.match(r"^imagine_embeddings\.(.*)$", key)
    if m:  # full (non-bypass) imagine encoder
        sub = m.group(1)
        if sub == "position_embeddings.weight":
            return "imagine_embeddings/position_embeddings/embedding"
        mm = re.match(r"pano_img_linear\.(weight|bias)$", sub)
        if mm:
            return f"imagine_embeddings/pano_img_linear/{mm.group(1)}"
        mm = re.match(r"(pano_img_layer_norm|layer_norm)\.(weight|bias)$", sub)
        if mm:
            return f"imagine_embeddings/{mm.group(1)}/ln/{mm.group(2)}"
        mm = re.match(r"pano_encoder\.layer\.(\d+)\.(.*)$", sub)
        if mm:
            rest = _apply_block(_BERT_LAYER, mm.group(2))
            return (f"imagine_embeddings/pano_encoder/layer_{mm.group(1)}/{rest}"
                    if rest else None)
        return None

    m = re.match(
        r"^contrastive_alignment_model\.image_proj\.fc([123])\.weight$", key)
    if m:
        return f"image_proj/fc{m.group(1)}/weight"

    for head in ("next_action", "ref_object"):
        for rule in _seq_rules(head, head,
                               {0: "dense0", 2: "LayerNorm/ln", 4: "dense1"}):
            mm = re.match("^" + rule[0], key)
            if mm:
                return re.sub(rule[0], rule[1], key)

    # NavRefCMT object segment (vlnbert_navref.py:11-41)
    m = re.match(r"^obj_embeddings\.(img|ang|pos)_linear\.(weight|bias)$",
                 key)
    if m:
        return f"obj_embeddings/{m.group(1)}_linear/{m.group(2)}"
    m = re.match(r"^obj_embeddings\.(img|ang|pos)_layer_norm"
                 r"\.(weight|bias)$", key)
    if m:
        return f"obj_embeddings/{m.group(1)}_layer_norm/ln/{m.group(2)}"
    m = re.match(r"^obj_embeddings\.layer_norm\.(weight|bias)$", key)
    if m:
        return f"obj_embeddings/layer_norm/ln/{m.group(1)}"

    if key in ("pooler.dense.weight", "pooler.dense.bias"):
        return None  # BertPooler exists in BERT inits but is unused
    p = _mlm_head_path(key)
    if p is not None:
        return p
    return None


def _mlm_head_path(key: str) -> str | None:
    """BertLMPredictionHead keys ('cls.predictions.*' in HF BERT,
    'mlm_head.predictions.*' after the reference's pretrain remap,
    train_r2r.py:134-136) -> our tied MLMHead params.  The decoder weight is
    tied to the word embedding (pretrain_cmt.py:96-99) and the decoder bias
    duplicates 'bias', so both are intentionally dropped."""
    m = re.match(r"^(?:cls|mlm_head)\.predictions\.(.*)$", key)
    if not m:
        return None
    rest = m.group(1)
    if rest == "bias":
        return "mlm_head/bias"
    mm = re.match(r"^transform\.dense\.(weight|bias)$", rest)
    if mm:
        return f"mlm_head/dense/{mm.group(1)}"
    mm = re.match(r"^transform\.LayerNorm\.(weight|bias)$", rest)
    if mm:
        return f"mlm_head/LayerNorm/ln/{mm.group(1)}"
    return None


def lxmert_remap(state_dict: dict) -> dict:
    """model_LXRT.pth -> GlocalTextPathCMT key space, the reference's LXMERT
    init surgery (train_r2r.py:120-139): the language layers to
    lang_encoder, the 5 LXMERT x-layers DUPLICATED into both the local and
    the global cross-modal encoders, cls.predictions to mlm_head."""
    out = {}
    for k, v in state_dict.items():
        k = k.replace("module.", "")
        if "bert.encoder.layer" in k:
            out[k.replace("bert.encoder.layer",
                          "bert.lang_encoder.layer")] = v
        elif "bert.encoder.x_layers" in k:
            out[k.replace("bert.encoder.x_layers",
                          "bert.local_encoder.encoder.x_layers")] = v
            out[k.replace("bert.encoder.x_layers",
                          "bert.global_encoder.encoder.x_layers")] = v
        elif "cls.predictions" in k:
            out[k.replace("cls.predictions", "mlm_head.predictions")] = v
        else:
            out[k] = v
    return out


def bert_remap_for_duet(state_dict: dict) -> dict:
    """HF bert-base-uncased keys -> GlocalTextPathCMT key space.  The
    reference's 'bert' init branch copies HF names verbatim
    (train_r2r.py:110-119), where 'encoder.layer.*' matches nothing in the
    DUET model and only the embeddings transfer; here the language layers
    are remapped onto lang_encoder, so a BERT init fills them too."""
    return {k.replace("module.", "").replace("encoder.layer.",
                                             "lang_encoder.layer."): v
            for k, v in state_dict.items()}


def duet_torch_to_flax_path(key: str) -> str | None:
    """GlocalTextPathNavCMT torch key -> flax param path, or None if the key
    is intentionally dropped.  The pano encoder's packed
    `self_attn.in_proj_{weight,bias}` map to a `__`-marked path that the
    converters split into query/key/value."""
    key = re.sub(r"^module\.", "", key)
    key = re.sub(r"^(bert|vln_bert)\.", "", key)
    if key.startswith("imagine_vit."):
        return _nested("imagine_vit", vit_torch_to_flax_path, key)

    for pat, repl in _EMBEDDINGS:
        if re.match(pat, key):
            return re.sub(pat, repl, key)

    m = re.match(r"^lang_encoder\.layer\.(\d+)\.(.*)$", key)
    if m:
        rest = _apply_block(_BERT_LAYER, m.group(2))
        return f"lang_layer_{m.group(1)}/{rest}" if rest else None

    m = re.match(r"^img_embeddings\.(img|loc|obj)_linear\.(weight|bias)$", key)
    if m:
        return f"{m.group(1)}_linear/{m.group(2)}"
    m = re.match(r"^img_embeddings\.(img|loc|obj)_layer_norm\.(weight|bias)$",
                 key)
    if m:
        return f"{m.group(1)}_layer_norm/ln/{m.group(2)}"
    if key == "img_embeddings.nav_type_embedding.weight":
        return "nav_type_embedding/embedding"
    m = re.match(r"^img_embeddings\.layer_norm\.(weight|bias)$", key)
    if m:
        return f"img_final_norm/ln/{m.group(1)}"
    m = re.match(r"^img_embeddings\.pano_encoder\.layers\.(\d+)\.(.*)$", key)
    if m:
        rest = _apply_block(_PRENORM_LAYER, m.group(2))
        return (f"pano_encoder/layer_{m.group(1)}/{rest}" if rest else
                f"pano_encoder/layer_{m.group(1)}/__{m.group(2)}")
    m = re.match(r"^img_embeddings\.pano_encoder\.norm\.(weight|bias)$", key)
    if m:
        return f"pano_encoder/norm/ln/{m.group(1)}"

    m = re.match(r"^local_encoder\.vp_pos_embeddings\.0\.(weight|bias)$", key)
    if m:
        return f"vp_pos_linear/{m.group(1)}"
    m = re.match(r"^local_encoder\.vp_pos_embeddings\.1\.(weight|bias)$", key)
    if m:
        return f"vp_pos_norm/ln/{m.group(1)}"
    m = re.match(r"^local_encoder\.encoder\.x_layers\.(\d+)\.(.*)$", key)
    if m:
        rest = _apply_block(_X_LAYER, m.group(2))
        return f"local_encoder/x_layer_{m.group(1)}/{rest}" if rest else None

    m = re.match(r"^global_encoder\.gmap_pos_embeddings\.0\.(weight|bias)$",
                 key)
    if m:
        return f"gmap_pos_linear/{m.group(1)}"
    m = re.match(r"^global_encoder\.gmap_pos_embeddings\.1\.(weight|bias)$",
                 key)
    if m:
        return f"gmap_pos_norm/ln/{m.group(1)}"
    if key == "global_encoder.gmap_step_embeddings.weight":
        return "gmap_step_embeddings/embedding"
    m = re.match(r"^global_encoder\.sprel_linear\.(weight|bias)$", key)
    if m:
        return f"sprel_linear/{m.group(1)}"
    m = re.match(r"^global_encoder\.encoder\.x_layers\.(\d+)\.(.*)$", key)
    if m:
        rest = _apply_block(_X_LAYER, m.group(2))
        return f"global_encoder/x_layer_{m.group(1)}/{rest}" if rest else None

    for head in ("global_sap_head", "local_sap_head", "sap_fuse_linear",
                 "og_head"):
        for rule in _seq_rules(head, head,
                               {0: "dense0", 2: "LayerNorm/ln", 3: "dense1"}):
            if re.match("^" + rule[0], key):
                return re.sub(rule[0], rule[1], key)

    if key == "imagine_embeddings.type_embedding.weight":
        return "imagine_embeddings/type_embedding/embedding"
    m = re.match(
        r"^contrastive_alignment_model\.image_proj\.fc([123])\.weight$", key)
    if m:
        return f"image_proj/fc{m.group(1)}/weight"
    return _mlm_head_path(key)


_VIT_BLOCK = [
    (r"^norm(1|2)\.(weight|bias)$", r"norm\1/\2"),
    (r"^attn\.qkv\.(weight|bias)$", r"qkv/\1"),
    (r"^attn\.proj\.(weight|bias)$", r"proj/\1"),
    (r"^mlp\.fc(1|2)\.(weight|bias)$", r"fc\1/\2"),
]


def vit_torch_to_flax_path(key: str) -> str | None:
    """timm vit_base_patch16_224 key -> flax path of the JAX package's
    VisionTransformer, or None for the classification head.  The patch
    conv maps to a `__conv_` marked leaf that the converters transpose."""
    key = re.sub(r"^module\.", "", key)
    if key in ("cls_token", "pos_embed"):
        return key
    m = re.match(r"^patch_embed\.proj\.(weight|bias)$", key)
    if m:
        return f"patch_embed/__conv_{m.group(1)}"
    m = re.match(r"^blocks\.(\d+)\.(.*)$", key)
    if m:
        for pat, repl in _VIT_BLOCK:
            if re.match(pat, m.group(2)):
                return f"block_{m.group(1)}/" + re.sub(pat, repl, m.group(2))
        return None
    m = re.match(r"^norm\.(weight|bias)$", key)
    if m:
        return f"norm/{m.group(1)}"
    return None  # head / pre_logits: unused for features


def _nested(prefix: str, inner, key: str) -> str | None:
    """`prefix.` + an inner model's key -> `prefix/` + its flax path."""
    if not key.startswith(prefix + "."):
        return None
    path = inner(key[len(prefix) + 1:])
    return None if path is None else f"{prefix}/{path}"


_PRETRAIN_HEADS = ("regress_action", "sprel_head", "image_classifier",
                   "itm_head")


def hamt_pretrain_torch_to_flax_path(key: str) -> str | None:
    """HamtPretrainModel key -> flax path: the shared backbone and
    next_action as the fine-tune model, the MLM head as a BERT checkpoint's
    (`_mlm_head_path`), and the other heads by their flax names."""
    key = re.sub(r"^module\.", "", key)
    m = re.match(rf"^({'|'.join(_PRETRAIN_HEADS)})\.(dense0|dense1)"
                 r"\.(weight|bias)$", key)
    if m:
        return f"{m.group(1)}/{m.group(2)}/{m.group(3)}"
    m = re.match(rf"^({'|'.join(_PRETRAIN_HEADS)})\.LayerNorm"
                 r"\.(weight|bias)$", key)
    if m:
        return f"{m.group(1)}/LayerNorm/ln/{m.group(2)}"
    return hamt_torch_to_flax_path(key)


def hamt_e2e_pretrain_torch_to_flax_path(key: str) -> str | None:
    """HamtE2EPretrainModel key: `vit.*` (the ViT) or `head_model.*` (a
    HamtPretrainModel)."""
    key = re.sub(r"^module\.", "", key)
    return (_nested("vit", vit_torch_to_flax_path, key)
            or _nested("head_model", hamt_pretrain_torch_to_flax_path, key))


# the DUET pre-training model's modules beside its `bert` backbone
DUET_PRETRAIN_HEADS = ("mlm_head", "image_classifier", "global_sap_head",
                       "local_sap_head", "sap_fuse_linear", "og_head")


def duet_pretrain_torch_to_flax_path(key: str) -> str | None:
    """DuetPretrainModel key -> flax path: `bert.*` and the SAP / OG heads
    as the navigator's (`duet_torch_to_flax_path`), the MLM head as a BERT
    checkpoint's, `image_classifier` by its flax names."""
    key = re.sub(r"^module\.", "", key)
    m = re.match(r"^image_classifier\.(dense0|dense1)\.(weight|bias)$", key)
    if m:
        return f"image_classifier/{m.group(1)}/{m.group(2)}"
    m = re.match(r"^image_classifier\.LayerNorm\.(weight|bias)$", key)
    if m:
        return f"image_classifier/LayerNorm/ln/{m.group(1)}"
    top = key.split(".")[0]
    if top == "bert":
        path = duet_torch_to_flax_path(key)
        return (None if path is None
                or path.split("/")[0] in DUET_PRETRAIN_HEADS else path)
    return duet_torch_to_flax_path(key) if top in DUET_PRETRAIN_HEADS else None


def duet_pretrain_key(key: str) -> str:
    """A reference key (GlocalTextPathCMT names, `module.` / `bert.`
    prefixed or not; `cls.predictions.*`) -> the DuetPretrainModel key."""
    key = re.sub(r"^(bert|vln_bert)\.", "", re.sub(r"^module\.", "", key))
    key = re.sub(r"^cls\.predictions\.", "mlm_head.predictions.", key)
    return key if key.split(".")[0] in DUET_PRETRAIN_HEADS else "bert." + key


def strip_reference_prefixes(state_dict: dict) -> dict:
    """Released checkpoints wrap NavCMT as `module.vln_bert.*` (DDP +
    VLNBertCMT); pre-train inits use `bert.*`.  Returns the port's keys."""
    return {re.sub(r"^(bert|vln_bert)\.", "", re.sub(r"^module\.", "", k)): v
            for k, v in state_dict.items()}


_TO_FLAX = {"hamt": hamt_torch_to_flax_path, "duet": duet_torch_to_flax_path,
            "vit": vit_torch_to_flax_path,
            "hamt_pretrain": hamt_pretrain_torch_to_flax_path,
            "hamt_e2e_pretrain": hamt_e2e_pretrain_torch_to_flax_path,
            "duet_pretrain": duet_pretrain_torch_to_flax_path}
_FLAX_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight",
                       "embedding": "weight"}
_HEAD_INDEX = {"hamt": {"dense0": "net.0", "LayerNorm": "net.2",
                        "dense1": "net.4"},
               "duet": {"dense0": "net.0", "LayerNorm": "net.2",
                        "dense1": "net.3"}}
_HEADS = {"hamt": ("next_action", "ref_object"),
          "duet": ("global_sap_head", "local_sap_head", "sap_fuse_linear",
                   "og_head")}
# DUET flax top-level modules that sit deeper in the torch tree
_DUET_TOP = {
    "img_linear": "img_embeddings.img_linear",
    "img_layer_norm": "img_embeddings.img_layer_norm",
    "loc_linear": "img_embeddings.loc_linear",
    "loc_layer_norm": "img_embeddings.loc_layer_norm",
    "obj_linear": "img_embeddings.obj_linear",
    "obj_layer_norm": "img_embeddings.obj_layer_norm",
    "nav_type_embedding": "img_embeddings.nav_type_embedding",
    "img_final_norm": "img_embeddings.layer_norm",
    "pano_encoder": "img_embeddings.pano_encoder",
    "vp_pos_linear": "local_encoder.vp_pos_embeddings.0",
    "vp_pos_norm": "local_encoder.vp_pos_embeddings.1",
    "gmap_pos_linear": "global_encoder.gmap_pos_embeddings.0",
    "gmap_pos_norm": "global_encoder.gmap_pos_embeddings.1",
    "gmap_step_embeddings": "global_encoder.gmap_step_embeddings",
    "sprel_linear": "global_encoder.sprel_linear",
}
_PANO_QKV = re.compile(r"(pano_encoder/layer_(\d+))/self_attn/(query|key|value)"
                       r"/(kernel|bias)")


_VIT_MODS = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1",
             "fc2": "mlp.fc2"}


def _vit_flax_to_torch(path: str) -> str:
    """Inverse of `vit_torch_to_flax_path`, checked against it."""
    *mods, leaf = path.split("/")
    if not mods:
        key = leaf
    elif mods == ["patch_embed"]:
        key = "patch_embed.proj." + ("weight" if leaf == "kernel" else leaf)
    else:
        mods = [re.sub(r"^block_(\d+)$", r"blocks.\1", _VIT_MODS.get(m, m))
                for m in mods]
        key = ".".join(mods + [_FLAX_LEAF_TO_TORCH.get(leaf, leaf)])
    want = vit_torch_to_flax_path(key)
    if want is not None:
        want = want.replace("__conv_weight", "kernel").replace(
            "__conv_bias", "bias")
        if want.endswith("/weight"):
            want = want[:-len("weight")] + leaf
    if want != path:
        raise KeyError(f"no ViT key maps to flax path {path!r} (tried {key!r})")
    return key


def flax_to_torch_key(path: str, agent: str = "hamt") -> str:
    """Inverse of `hamt_torch_to_flax_path` / `duet_torch_to_flax_path` (and
    of the ViT and pre-training maps, `_TO_FLAX`) for a flax leaf path
    (slash-separated, leaf `kernel`/`scale`/`embedding`/`bias`/...).  The
    result is checked against the forward map, so the two cannot drift."""
    top, _, rest = path.partition("/")
    if agent == "vit":
        return _vit_flax_to_torch(path)
    if agent == "hamt_e2e_pretrain":
        inner = "vit" if top == "vit" else "hamt_pretrain"
        return f"{top}." + flax_to_torch_key(rest, inner)
    if top == "imagine_vit" and agent in ("hamt", "duet"):
        return "imagine_vit." + _vit_flax_to_torch(rest)
    # the pre-training models' backbones (and heads) are the navigators'
    base = {"hamt_pretrain": "hamt", "duet_pretrain": "duet"}.get(agent, agent)
    *mods, leaf = path.split("/")
    mods = [m for m in mods if m != "ln"]
    top = mods[0]
    layer = "layer"
    if m := re.fullmatch(r"lang_layer_(\d+)", top):
        mods = ["lang_encoder" if base == "duet" else "encoder", "layer",
                m.group(1)] + mods[1:]
    elif m := re.fullmatch(r"x_layer_(\d+)", top):
        mods = ["encoder", "x_layers", m.group(1)] + mods[1:]
    elif base == "duet" and top in ("local_encoder", "global_encoder"):
        n = re.fullmatch(r"x_layer_(\d+)", mods[1]).group(1)
        mods = [top, "encoder", "x_layers", n] + mods[2:]
    elif base == "duet" and top in _DUET_TOP:
        mods = _DUET_TOP[top].split(".") + [
            "self_attn.out_proj" if m == "out_proj" else m for m in mods[1:]]
        layer = "layers"
    elif top == "image_proj":
        mods = ["contrastive_alignment_model"] + mods
    elif top in _HEADS[base]:
        mods = [top, _HEAD_INDEX[base][mods[1]]] + mods[2:]
    elif top == "mlm_head":  # a BERT checkpoint's BertLMPredictionHead
        mods = [top, "predictions"] + (["transform"] if len(mods) > 1
                                       else []) + mods[1:]
    mods = [re.sub(r"^layer_(\d+)$", rf"{layer}.\1", m) for m in mods]
    if agent == "duet_pretrain" and top not in DUET_PRETRAIN_HEADS:
        mods = ["bert"] + mods
    key = ".".join(mods + [_FLAX_LEAF_TO_TORCH.get(leaf, leaf)])
    want = "/".join(path.split("/")[:-1]
                    + ["embedding" if leaf == "embedding" else
                       "weight" if leaf in ("kernel", "scale") else leaf])
    if _TO_FLAX[agent](key) != want:
        raise KeyError(f"no torch key maps to flax path {path!r} (tried {key!r})")
    return key



def _flax_leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flax_leaves(v, path)
        else:
            yield path, v


def _in_proj_key(layer: str, agent: str = "duet") -> str:
    """The torch prefix of pano encoder layer `layer`'s packed projection."""
    key = ("bert." if agent == "duet_pretrain" else "") + \
        f"img_embeddings.pano_encoder.layers.{layer}.self_attn.in_proj_"
    if _TO_FLAX[agent](key + "weight") != \
            f"pano_encoder/layer_{layer}/__self_attn.in_proj_weight":
        raise KeyError(f"no in_proj key for pano encoder layer {layer}")
    return key


def state_dict_from_flax(params: dict, agent: str = "hamt") -> dict[str, Any]:
    """JAX package params (`{"params": tree}` or the tree itself, numpy
    leaves) of `agent` (a key of `_TO_FLAX`) -> the port's state_dict of torch
    tensors.  DUET's pano encoder query/key/value kernels and biases are
    stacked into torch's `in_proj_weight` [3H, H] / `in_proj_bias` [3H]."""
    tree = params.get("params", params)
    sd, qkv = {}, {}
    for path, value in _flax_leaves(tree):
        v = np.asarray(value, np.float32)
        if path.endswith("/kernel"):
            # conv [kh, kw, I, O] -> [O, I, kh, kw]; dense [in, out] -> [out, in]
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        m = (_PANO_QKV.fullmatch(path)
             if agent in ("duet", "duet_pretrain") else None)
        if m:
            qkv.setdefault(m.group(2), {})[(m.group(3), m.group(4))] = v
            continue
        sd[flax_to_torch_key(path, agent)] = torch.tensor(v)
    for layer, parts in qkv.items():
        key = _in_proj_key(layer, agent)
        for leaf, torch_leaf in (("kernel", "weight"), ("bias", "bias")):
            sd[key + torch_leaf] = torch.tensor(np.concatenate(
                [parts[(name, leaf)] for name in ("query", "key", "value")]))
    return sd


def flax_from_state_dict(state_dict: dict, agent: str = "hamt") -> dict:
    """The port's (or a released, prefix-stripped) state_dict of `agent` ->
    JAX package params `{"params": tree}` of numpy arrays.  Keys the map
    drops (unused heads, 0-layer stacks) are left out; DUET's packed
    `in_proj_*` are split into query/key/value."""
    params: dict = {}
    for key, value in state_dict.items():
        path = _TO_FLAX[agent](key)
        if path is None:
            continue
        v = value.detach().cpu().numpy() if hasattr(value, "detach") else np.asarray(value)
        if "/__self_attn.in_proj_" in path:
            base = path.split("/__")[0] + "/self_attn"
            leaf = "kernel" if path.endswith("weight") else "bias"
            for name, part in zip(("query", "key", "value"),
                                  np.split(v, 3, axis=0)):
                node = params
                for p in f"{base}/{name}".split("/"):
                    node = node.setdefault(p, {})
                node[leaf] = part.T if leaf == "kernel" else part
            continue
        base, _, leaf = path.rpartition("/")
        if leaf == "__conv_weight":
            leaf, v = "kernel", v.transpose(2, 3, 1, 0)
        elif leaf == "__conv_bias":
            leaf = "bias"
        elif leaf == "weight":
            if base.endswith("/ln") or v.ndim == 1:
                leaf = "scale"
            else:
                leaf, v = "kernel", v.T
        node = params
        for part in base.split("/") if base else ():
            node = node.setdefault(part, {})
        node[leaf] = v
    return {"params": params}


_CRITIC_KEYS = {"state2value.0": "fc0", "state2value.3": "fc1"}


def critic_torch_to_flax_path(key: str) -> str | None:
    """Critic torch key (`state2value.{0,3}.{weight,bias}`, model_HAMT.py)
    -> flax param path of the JAX package's `Critic`, or None."""
    m = re.match(r"^(state2value\.[03])\.(weight|bias)$",
                 re.sub(r"^module\.", "", key))
    return f"{_CRITIC_KEYS[m.group(1)]}/{m.group(2)}" if m else None


def critic_state_dict_from_flax(params: dict) -> dict[str, Any]:
    """JAX package critic params (`{"params": {fc0, fc1}}` or the tree) ->
    the port's `Critic` state_dict."""
    tree = params.get("params", params)
    inverse = {v: k for k, v in _CRITIC_KEYS.items()}
    sd = {}
    for path, value in _flax_leaves(tree):
        mod, leaf = path.split("/")
        v = np.asarray(value, np.float32)
        if leaf == "kernel":
            v, leaf = v.T, "weight"
        key = f"{inverse[mod]}.{leaf}"
        if critic_torch_to_flax_path(key) != f"{mod}/{leaf}":
            raise KeyError(f"no critic key maps to flax path {path!r}")
        sd[key] = torch.tensor(v)
    return sd


def critic_flax_from_state_dict(state_dict: dict) -> dict:
    """The port's (or a released, prefix-stripped) critic state_dict -> JAX
    package critic params `{"params": {fc0, fc1}}` of numpy arrays."""
    params: dict = {}
    for key, value in state_dict.items():
        path = critic_torch_to_flax_path(key)
        if path is None:
            continue
        mod, leaf = path.split("/")
        v = value.detach().cpu().numpy() if hasattr(value, "detach") else np.asarray(value)
        if leaf == "weight":
            leaf, v = "kernel", v.T
        params.setdefault(mod, {})[leaf] = v
    return {"params": params}
