"""Pre-train -> fine-tune weight transfer.

The reference remaps checkpoint keys at model-construction time
(VLN-HAMT/finetune_src/models/vlnbert_init.py:20-31,
VLN-DUET/pretrain_src/train_r2r.py:120-139).  Because the pre-train and
fine-tune models share submodule names (embeddings, lang_layer_i,
x_layer_i, img/hist_embeddings, local/global encoders, sap heads), transfer
is a shape-checked subtree copy: matching top-level modules take the
pre-trained values; fine-tune-only modules (imagination, aux-loss head,
next_action / critic at random init) keep their initialisation.

The port's own copy of `vln_imagine_tpu/ckpt/transfer.py`.  It walks the
flax-layout trees of numpy arrays that `ckpt/convert.py:flax_from_state_dict`
builds, so `transferred` and `missing` count exactly what the JAX package's
counts.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def _as_numpy(tree: Any) -> Any:
    # keys sorted, as jax.tree.map rebuilds a dict: the walk below (and so
    # the order of `missing`) follows them
    if isinstance(tree, dict):
        return {k: _as_numpy(tree[k]) for k in sorted(tree)}
    return np.asarray(tree)


def init_finetune_from_pretrain(ft_params: Any, pt_params: Any
                                ) -> tuple[Any, int, list]:
    """Returns (new_ft_params, n_leaves_transferred, missing) where missing
    lists (module, reason) for fine-tune modules without a pre-trained
    counterpart or with shape mismatches."""
    ft = _as_numpy(ft_params)
    pt = _as_numpy(pt_params)
    ft_inner = ft["params"] if "params" in ft else ft
    pt_inner = pt["params"] if "params" in pt else pt

    transferred = 0
    missing: list[tuple[str, str]] = []

    def merge(dst, src, path):
        nonlocal transferred
        out = {}
        for k, v in dst.items():
            if k not in src:
                missing.append(("/".join(path + (k,)), "not in pretrain"))
                out[k] = v
            elif isinstance(v, dict):
                out[k] = merge(v, src[k], path + (k,))
            elif np.shape(v) != np.shape(src[k]):
                missing.append(("/".join(path + (k,)),
                                f"shape {np.shape(src[k])} vs {np.shape(v)}"))
                out[k] = v
            else:
                out[k] = src[k]
                transferred += 1
        return out

    merged = merge(ft_inner, pt_inner, ())
    result = dict(ft)
    if "params" in ft:
        result["params"] = merged
    else:
        result = merged
    return result, transferred, missing
