"""Weight bridge: the reference's torch keys <-> flax params of the JAX package.

The port's modules carry the reference's torch key names (NavCMT,
VLN-HAMT/finetune_src/models/vilmodel_cmt.py), so a released checkpoint
loads with `load_state_dict` once its `module.` / `vln_bert.` prefixes are
stripped (`strip_reference_prefixes`).  The key map below is the port's own
copy of the HAMT rules of the JAX package's converter; on top of it,
`state_dict_from_flax` turns that package's params (a nested dict of numpy
arrays) into the port's state_dict and `flax_from_state_dict` goes back.

Conversion rules:
- torch nn.Linear weight [out, in]  <-> flax Dense kernel [in, out]
- torch nn.Embedding weight         <-> flax Embed embedding
- torch LayerNorm weight/bias       <-> flax LayerNorm ln/scale, ln/bias
- nn.Sequential heads map by index (NextActionPrediction net.{0,2,4})
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


def strip_reference_prefixes(state_dict: dict) -> dict:
    """Released checkpoints wrap NavCMT as `module.vln_bert.*` (DDP +
    VLNBertCMT); pre-train inits use `bert.*`.  Returns the port's keys."""
    return {re.sub(r"^(bert|vln_bert)\.", "", re.sub(r"^module\.", "", k)): v
            for k, v in state_dict.items()}


_FLAX_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight",
                       "embedding": "weight"}
_HEAD_INDEX = {"dense0": "net.0", "LayerNorm": "net.2", "dense1": "net.4"}


def flax_to_hamt_torch_key(path: str) -> str:
    """Inverse of `hamt_torch_to_flax_path` for a flax leaf path
    (slash-separated, leaf `kernel`/`scale`/`embedding`/`bias`/...).  The
    result is checked against the forward map, so the two cannot drift."""
    *mods, leaf = path.split("/")
    mods = [m for m in mods if m != "ln"]
    top = mods[0]
    if m := re.fullmatch(r"lang_layer_(\d+)", top):
        mods = ["encoder", "layer", m.group(1)] + mods[1:]
    elif m := re.fullmatch(r"x_layer_(\d+)", top):
        mods = ["encoder", "x_layers", m.group(1)] + mods[1:]
    elif top == "image_proj":
        mods = ["contrastive_alignment_model"] + mods
    elif top in ("next_action", "ref_object"):
        mods = [top, _HEAD_INDEX[mods[1]]] + mods[2:]
    mods = [re.sub(r"^layer_(\d+)$", r"layer.\1", m) for m in mods]
    key = ".".join(mods + [_FLAX_LEAF_TO_TORCH.get(leaf, leaf)])
    want = "/".join(path.split("/")[:-1]
                    + ["embedding" if leaf == "embedding" else
                       "weight" if leaf in ("kernel", "scale") else leaf])
    if hamt_torch_to_flax_path(key) != want:
        raise KeyError(f"no torch key maps to flax path {path!r} (tried {key!r})")
    return key


def _flax_leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flax_leaves(v, path)
        else:
            yield path, v


def state_dict_from_flax(params: dict) -> dict[str, Any]:
    """JAX package params (`{"params": tree}` or the tree itself, numpy
    leaves) -> the port's state_dict of torch tensors."""
    tree = params.get("params", params)
    sd = {}
    for path, value in _flax_leaves(tree):
        v = np.asarray(value, np.float32)
        if path.endswith("/kernel"):
            v = v.T
        sd[flax_to_hamt_torch_key(path)] = torch.tensor(v)
    return sd


def flax_from_state_dict(state_dict: dict) -> dict:
    """The port's (or a released, prefix-stripped) state_dict -> JAX package
    params `{"params": tree}` of numpy arrays.  Keys the HAMT map drops
    (unused heads, 0-layer stacks) are left out."""
    params: dict = {}
    for key, value in state_dict.items():
        path = hamt_torch_to_flax_path(key)
        if path is None:
            continue
        v = value.detach().cpu().numpy() if hasattr(value, "detach") else np.asarray(value)
        base, leaf = path.rsplit("/", 1)
        if leaf == "weight":
            if base.endswith("/ln") or v.ndim == 1:
                leaf = "scale"
            else:
                leaf, v = "kernel", v.T
        node = params
        for part in base.split("/"):
            node = node.setdefault(part, {})
        node[leaf] = v
    return {"params": params}
