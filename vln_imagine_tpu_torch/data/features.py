"""Image / imagination feature stores.

Rebuild of ImageFeaturesDB and ImaginationImageFeaturesDB
(VLN-HAMT/finetune_src/r2r/data_utils.py:15-47): HDF5 files keyed
'<scan>_<viewpoint>' -> [36, d] view features, and '<instr_id>' ->
[n_imaginations, d] imagination features, each with an in-process cache.

`build_feature_table` materialises the whole split's features as one
[S, N, V, D] array aligned with the compiled world's node indexing, so the
rollout reads features by table gather on the device instead of per-step
host lookups.

The port's own copy of the JAX package's module.  h5py is optional: an HDF5
store used without it raises ImportError.  Not ported yet: the raw image
banks (ROADMAP Queue 1 item 5) and the REVERIE/SOON object stores (item 4).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None


def _require_h5py() -> None:
    if h5py is None:
        raise ImportError("h5py is needed to read HDF5 feature files; use "
                          "InMemoryFeaturesDB for features held in memory")


class ImageFeaturesDB:
    def __init__(self, img_ft_file: str, image_feat_size: int):
        _require_h5py()
        self.img_ft_file = img_ft_file
        self.image_feat_size = image_feat_size
        self._cache: dict[str, np.ndarray] = {}

    def get_image_feature(self, scan: str, viewpoint: str) -> np.ndarray:
        key = f"{scan}_{viewpoint}"
        if key not in self._cache:
            with h5py.File(self.img_ft_file, "r") as f:
                ft = f[key][...][:, : self.image_feat_size].astype(np.float32)
            self._cache[key] = ft
        return self._cache[key]


class ImaginationImageFeaturesDB:
    def __init__(self, img_ft_file: str, image_feat_size: int):
        _require_h5py()
        self.img_ft_file = img_ft_file
        self.image_feat_size = image_feat_size
        self._cache: dict[str, np.ndarray] = {}

    def get_image_feature(self, instr_id: str) -> np.ndarray:
        if instr_id not in self._cache:
            with h5py.File(self.img_ft_file, "r") as f:
                ft = f[instr_id][...][:, : self.image_feat_size].astype(
                    np.float32)
            self._cache[instr_id] = ft
        return self._cache[instr_id]


class InMemoryFeaturesDB:
    """Dict-backed store with the same surface (tests / synthetic worlds)."""

    def __init__(self, table: dict[str, np.ndarray]):
        self._table = table

    def get_image_feature(self, *key_parts) -> np.ndarray:
        return self._table["_".join(key_parts)]


def build_feature_table(
    db, graphs, views: int = 36, feat_dim: int = 768,
    max_nodes: int | None = None,
) -> np.ndarray:
    """[S, N, views, feat_dim] table aligned with compile_world's padding."""
    N = max_nodes or max(g.num_nodes for g in graphs)
    out = np.zeros((len(graphs), N, views, feat_dim), np.float32)
    for s, g in enumerate(graphs):
        for i, vp in enumerate(g.node_ids):
            out[s, i] = db.get_image_feature(g.scan_id, vp)[:, :feat_dim]
    return out


def _scatter_by_flags(instr_ids, generated_flags, max_imaginations,
                      get_rows, out: np.ndarray) -> np.ndarray:
    """Scatter per-instruction rows into sub-instruction slots whose
    generated-flag is 'True' (agent_cmt.py:247-313
    `_create_diffusion_imaginations_v2`); fills `out[b, i]` in place and
    returns the [B, I] validity mask."""
    mask = np.zeros(out.shape[:2], bool)
    for b, instr_id in enumerate(instr_ids):
        flags = [f == "True" for f in generated_flags[instr_id]]
        if not any(flags):
            continue
        rows = get_rows(instr_id)
        assert rows.shape[0] == sum(flags), (
            f"{instr_id}: {rows.shape[0]} imaginations vs "
            f"{sum(flags)} generated flags")
        j = 0
        for i, flag in enumerate(flags[:max_imaginations]):
            if flag:
                out[b, i] = rows[j]
                mask[b, i] = True
                j += 1
    return mask


def build_imagination_arrays_v1(
    db, instr_ids: Iterable[str], max_imaginations: int, feat_dim: int,
) -> tuple[np.ndarray, np.ndarray]:
    """V1 imagination format (`_create_diffusion_imaginations`,
    agent_cmt.py:217-246): each instruction's features are packed densely
    from slot 0 with a first-n validity mask — no generated-flag alignment
    to sub-instruction slots (that is the v2 format below)."""
    instr_ids = list(instr_ids)
    feats = np.zeros((len(instr_ids), max_imaginations, feat_dim), np.float32)
    mask = np.zeros((len(instr_ids), max_imaginations), bool)
    for b, iid in enumerate(instr_ids):
        rows = db.get_image_feature(iid)[:, :feat_dim]
        n = min(rows.shape[0], max_imaginations)
        feats[b, :n] = rows[:n]
        mask[b, :n] = True
    return feats, mask


def build_imagination_arrays(
    db, instr_ids: Iterable[str], generated_flags: dict[str, list[str]],
    max_imaginations: int, feat_dim: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-instruction imagination features scattered to sub-instruction
    slots (agent_cmt.py:247-313 `_create_diffusion_imaginations_v2`): slot i
    holds the feature of sub-instruction i when its generated-flag is 'True'.

    Returns (feats [B, I, D], mask [B, I])."""
    instr_ids = list(instr_ids)
    feats = np.zeros((len(instr_ids), max_imaginations, feat_dim), np.float32)
    mask = _scatter_by_flags(
        instr_ids, generated_flags, max_imaginations,
        lambda iid: db.get_image_feature(iid)[:, :feat_dim], feats)
    return feats, mask
