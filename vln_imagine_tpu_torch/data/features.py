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
store used without it raises ImportError; `build_object_tables` reads any
object with `ObjectFeatureDB.load_feature`'s signature.  Not ported yet:
the raw image banks (ROADMAP Queue 1 item 5).
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


class ObjectFeatureDB:
    """REVERIE/SOON object features: HDF5 '<scan>_<viewpoint>' ->
    [K, Do] features with attrs `directions` [K, 2] (heading/elevation),
    `obj_ids` [K], and `sizes` (REVERIE, w/h pixels) or `bboxes` (SOON,
    x1y1x2y2).  Port of VLN-DUET/map_nav_src/reverie/data_utils.py:9-52 and
    soon/data_utils.py:73-120, with the same in-process cache."""

    def __init__(self, obj_ft_file: str, obj_feat_size: int):
        _require_h5py()
        self.obj_ft_file = obj_ft_file
        self.obj_feat_size = obj_feat_size
        self._cache: dict[str, tuple[np.ndarray, dict]] = {}

    def load_feature(self, scan: str, viewpoint: str,
                     max_objects: int | None = None):
        key = f"{scan}_{viewpoint}"
        if key not in self._cache:
            attrs: dict = {}
            with h5py.File(self.obj_ft_file, "r") as f:
                if key in f:
                    fts = f[key][...][:, : self.obj_feat_size].astype(
                        np.float32)
                    for ak, av in f[key].attrs.items():
                        if ak in ("directions", "sizes", "bboxes", "obj_ids",
                                  "viewindexs"):
                            attrs[ak] = np.asarray(av)
                else:
                    fts = np.zeros((0, self.obj_feat_size), np.float32)
            self._cache[key] = (fts, attrs)
        fts, attrs = self._cache[key]
        if max_objects is not None:
            fts = fts[:max_objects]
            attrs = {k: v[:max_objects] for k, v in attrs.items()}
        return fts, attrs

    def box_features(self, attrs: dict) -> np.ndarray:
        """[K, 3] normalized (h, w, area) box features
        (reverie/data_utils.py:48-50: h/480, w/640; soon :114-117: /600)."""
        if "sizes" in attrs:  # REVERIE
            wh = np.asarray(attrs["sizes"], np.float32).reshape(-1, 2)
            h, w = wh[:, 1] / 480.0, wh[:, 0] / 640.0
        elif "bboxes" in attrs:  # SOON
            bb = np.asarray(attrs["bboxes"], np.float32).reshape(-1, 4)
            h = (bb[:, 3] - bb[:, 1]) / 600.0
            w = (bb[:, 2] - bb[:, 0]) / 600.0
        else:
            return np.zeros((0, 3), np.float32)
        return np.stack([h, w, h * w], -1).astype(np.float32)


def load_obj2vps(bbox_file: str) -> dict[str, list[str]]:
    """'<scan>_<objid>' -> viewpoints the object is visible from
    (reverie/data_utils.py:113-124)."""
    import json

    with open(bbox_file) as f:
        bbox_data = json.load(f)
    obj2vps: dict[str, list[str]] = {}
    for scanvp, value in bbox_data.items():
        scan, vp = scanvp.split("_", 1)
        for objid, objinfo in value.items():
            if objinfo["visible_pos"]:
                obj2vps.setdefault(f"{scan}_{objid}", []).append(vp)
    return obj2vps


def build_object_tables(
    db: ObjectFeatureDB, graphs, max_objects: int, obj_feat_dim: int,
    max_nodes: int | None = None, bbox_format: str = "xywh",
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           dict[str, int]]:
    """Compile per-(scan, viewpoint) object stores into dense WorldTables
    arrays: (obj_feat [S,N,Ko,D], obj_ang [S,N,Ko,2] absolute heading/elev,
    obj_valid [S,N,Ko], obj_ids [S,N,Ko] i32, obj_pos [S,N,Ko,5] normalized
    (x1,y1,x2,y2,area) bbox positions — get_obj_local_pos,
    reverie/data_utils.py:25-31 — and id_of str->i32).

    bbox_format: the 'bboxes' attr convention — 'xywh' (HAMT REVERIE) or
    'xyxy' (SOON).  'sizes'-only stores (DUET REVERIE) get x1=y1=0 with the
    w/h extent, which the DUET stack never reads (it uses box_features).

    An object's table visibility (which nodes carry its tokens) equals the
    reference's obj2vps map: the HDF5 stores an entry exactly at the
    viewpoints the object is visible from."""
    N = max_nodes or max(g.num_nodes for g in graphs)
    S = len(graphs)
    obj_feat = np.zeros((S, N, max_objects, obj_feat_dim), np.float32)
    obj_ang = np.zeros((S, N, max_objects, 2), np.float32)
    obj_valid = np.zeros((S, N, max_objects), bool)
    obj_ids = np.zeros((S, N, max_objects), np.int32)
    obj_pos = np.zeros((S, N, max_objects, 5), np.float32)
    id_of: dict[str, int] = {}

    warned_sizes = []

    def pos5(attrs, k: int) -> np.ndarray:
        # image planes: 640x480 for REVERIE (get_obj_local_pos,
        # reverie/data_utils.py:25-31), 600x600 for SOON's xyxy boxes
        # (soon/data_utils.py:112-117)
        W, H = (600.0, 600.0) if bbox_format == "xyxy" else (640.0, 480.0)
        if "bboxes" in attrs:
            bb = np.asarray(attrs["bboxes"], np.float32).reshape(-1, 4)[:k]
            if bbox_format == "xywh":
                x1, y1 = bb[:, 0], bb[:, 1]
                x2, y2 = x1 + bb[:, 2], y1 + bb[:, 3]
            else:  # xyxy (SOON)
                x1, y1, x2, y2 = bb[:, 0], bb[:, 1], bb[:, 2], bb[:, 3]
        elif "sizes" in attrs:
            # DUET-format store: extent only, no corner coordinates — the
            # x1=y1=0 degenerate positions are NOT what NavRef trained on
            if not warned_sizes:
                warned_sizes.append(True)
                import warnings
                warnings.warn(
                    "object store has 'sizes' but no 'bboxes'; obj_pos gets "
                    "degenerate x1=y1=0 positions — the HAMT NavRef stack "
                    "needs the bbox-format store (load_obj_database, "
                    "reverie/data_utils.py:33-43)", stacklevel=2)
            wh = np.asarray(attrs["sizes"], np.float32).reshape(-1, 2)[:k]
            x1 = y1 = np.zeros(len(wh), np.float32)
            x2, y2 = wh[:, 0], wh[:, 1]
        else:
            return np.zeros((k, 5), np.float32)
        return np.stack([x1 / W, y1 / H, x2 / W, y2 / H,
                         (x2 - x1) * (y2 - y1) / (W * H)],
                        -1).astype(np.float32)

    def intern(raw) -> int:
        s = raw.decode() if isinstance(raw, bytes) else str(raw)
        try:
            return int(s)
        except ValueError:
            # non-numeric ids (SOON pseudo labels): stable negative interning
            if s not in id_of:
                id_of[s] = -(len(id_of) + 1)
            return id_of[s]

    for s, g in enumerate(graphs):
        for n, vp in enumerate(g.node_ids):
            fts, attrs = db.load_feature(g.scan_id, vp,
                                         max_objects=max_objects)
            k = fts.shape[0]
            if k == 0:
                continue
            obj_feat[s, n, :k] = fts[:, :obj_feat_dim]
            if "directions" in attrs:
                obj_ang[s, n, :k] = np.asarray(
                    attrs["directions"], np.float32).reshape(-1, 2)[:k]
            elif "viewindexs" in attrs:
                # HAMT-format store (load_obj_database,
                # reverie/data_utils.py:33-43): the object's angle is the
                # discretized view it sits in (reverie/env.py:189-193
                # indexes the directional feature by viewindex)
                vi = np.asarray(attrs["viewindexs"], np.int64).reshape(-1)[:k]
                obj_ang[s, n, :k, 0] = (vi % 12) * np.radians(30.0)
                obj_ang[s, n, :k, 1] = (vi // 12 - 1) * np.radians(30.0)
            obj_pos[s, n, :k] = pos5(attrs, k)
            obj_valid[s, n, :k] = True
            for j, oid in enumerate(np.asarray(attrs.get(
                    "obj_ids", np.arange(k)))[:k]):
                v = intern(oid)
                obj_ids[s, n, j] = v
                id_of.setdefault(str(v), v)
    return obj_feat, obj_ang, obj_valid, obj_ids, obj_pos, id_of
