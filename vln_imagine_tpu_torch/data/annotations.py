"""Instruction annotations -> fixed-shape episode arrays.

Rebuild of load_instr_datasets / construct_instrs
(VLN-HAMT/finetune_src/r2r/data_utils.py:50-116) and the aux-loss metadata
wiring (sub-instruction segmentation + noun-phrase index JSONs, parser.py:
138-217; imagination-v2 generated-flag JSONs).  The spaCy/fuzzywuzzy offline
tools that PRODUCE those JSONs live in data/nlp_tools.py; this module only
consumes their output and emits EpisodeBatch arrays.

The port's own copy of the JAX package's module; its arrays and index
streams equal that package's, raw imagination images (`imagine_images`)
included.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from vln_imagine_tpu_torch.envx.compiler import ScanGraph, shortest_path_nodes
from vln_imagine_tpu_torch.envx.tables import EpisodeBatch


def load_instr_datasets(anno_dir: str, dataset: str,
                        splits: list[str]) -> list[dict]:
    """Official split files per task family (data_utils.py:50-82)."""
    data = []
    for split in splits:
        if "/" in split:  # augmented data path given directly
            with open(split) as f:
                data += json.load(f)
            continue
        if dataset == "r2r":
            path = os.path.join(anno_dir, f"R2R_{split}_enc.json")
        elif dataset == "fgr2r":
            path = os.path.join(anno_dir, f"FGR2R_{split}.json")
        elif dataset == "r2r_last":
            path = os.path.join(anno_dir, "LastSent", f"R2R_{split}_enc.json")
        elif dataset == "r2r_back":
            path = os.path.join(anno_dir, "ReturnBack",
                                f"R2R_{split}_enc.json")
        elif dataset == "r4r":
            path = os.path.join(anno_dir, f"R4R_{split}_enc.json")
        elif dataset == "rxr":
            path = os.path.join(anno_dir,
                                f"rxr_{split}_guide_enc_xlmr.jsonl")
            with open(path) as f:
                data += [json.loads(line) for line in f if line.strip()]
            continue
        elif dataset == "cvdn":
            # NDH annotations arrive pre-encoded with the concatenated
            # dialog history (cvdn/main.py:24-27)
            path = os.path.join(anno_dir, f"{split}_enc.json")
        elif dataset == "reverie":
            path = os.path.join(anno_dir, f"REVERIE_{split}_enc.json")
        elif dataset == "soon":
            # SOON ships jsonl with per-instruction dicts + goal bboxes
            # (soon/data_utils.py:27-54)
            path = os.path.join(anno_dir, "bert_enc",
                                f"{split}_enc_pseudo_obj_label.jsonl")
            if not os.path.exists(path):
                path = os.path.join(anno_dir, "bert_enc",
                                    f"{split}_enc.jsonl")
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    item = json.loads(line)
                    item["end_image_ids"] = [x["image_id"]
                                             for x in item["bboxes"]]
                    # image_id -> pseudo obj label (soon/data_utils.py:41)
                    item["image_id_to_obj_label"] = {
                        x["image_id"]: x.get("pseudo_label")
                        for x in item["bboxes"]}
                    item["bboxes"] = {x["image_id"]: x
                                      for x in item["bboxes"]}
                    data.append(item)
            continue
        else:
            raise ValueError(dataset)
        with open(path) as f:
            data += json.load(f)
    return data


def construct_instrs(anno_dir: str, dataset: str, splits: list[str],
                     max_instrs_per_path: int = 3,
                     aug_flag: bool = False) -> list[dict]:
    """One entry per instruction with instr_id '<path_id>_<j>'
    (data_utils.py:84-116; at most 3 instructions per path unless augmented)."""
    out = []
    for item in load_instr_datasets(anno_dir, dataset, splits):
        if dataset == "rxr":
            new_item = dict(item)
            if "path_id" in item:
                new_item["instr_id"] = \
                    f"{item['path_id']}_{item['instruction_id']}"
            else:
                new_item["path_id"] = new_item["instr_id"] = \
                    str(item["instruction_id"])
            out.append(new_item)
            continue
        for j, instr in enumerate(item["instructions"]):
            if j >= max_instrs_per_path and not aug_flag \
                    and dataset not in ("reverie", "soon"):
                continue
            new_item = dict(item)
            if dataset == "reverie":
                # '<path_id>_<objId>_<j>' (reverie/data_utils.py:94-111)
                if item.get("objId") is not None:
                    new_item["instr_id"] = \
                        f"{item['path_id']}_{item['objId']}_{j}"
                else:
                    new_item["path_id"] = item["id"]
                    new_item["instr_id"] = f"{item['id']}_{j}"
                    new_item["objId"] = None
                new_item["instruction"] = instr
                enc = item["instr_encodings"][j]
            elif dataset == "soon":
                # per-instruction dict with 'full' text variant
                # (soon/data_utils.py:56-70)
                new_item["instr_id"] = f"{item['path_id']}_{j}"
                new_item["instruction"] = instr["full"] \
                    if isinstance(instr, dict) else instr
                enc = item["instr_encodings"][j]
                if isinstance(enc, dict):
                    enc = enc["full"]
                # grounding target: the pseudo obj label at the goal
                # viewpoint (soon/env.py:257-264 reads it per-step from
                # image_id_to_obj_label; the stop viewpoint is path[-1])
                if new_item.get("objId") is None and item.get("path"):
                    label = item.get("image_id_to_obj_label", {}).get(
                        item["path"][-1])
                    new_item["objId"] = (label["obj_id"]
                                         if label is not None else None)
            else:
                new_item["instr_id"] = f"{item['path_id']}_{j}"
                new_item["instruction"] = instr
                enc = item["instr_encodings"][j]
            new_item["instr_encoding"] = enc
            new_item.pop("instructions", None)
            new_item.pop("instr_encodings", None)
            out.append(new_item)
    return out


@dataclass
class AuxMetadata:
    """Sub-instruction / noun-phrase / imagination metadata for one split."""

    sub_instr_segs: dict[str, list] = field(default_factory=dict)
    noun_phrase_segs: dict[str, list] = field(default_factory=dict)
    generated_flags: dict[str, list] = field(default_factory=dict)

    @classmethod
    def load(cls, sub_instr_file: str | None, generated_flag_file: str | None
             ) -> "AuxMetadata":
        meta = cls()
        if sub_instr_file and os.path.exists(sub_instr_file):
            with open(sub_instr_file) as f:
                for item in json.load(f):
                    iid = item["instruction_id"]
                    meta.sub_instr_segs[iid] = \
                        item["instr_segmentation_indices"]
                    meta.noun_phrase_segs[iid] = item["noun_phrase_indices"]
        if generated_flag_file and os.path.exists(generated_flag_file):
            with open(generated_flag_file) as f:
                meta.generated_flags = json.load(f)
        return meta


def np_weight_matrix(instr_id: str, meta: AuxMetadata, max_imaginations: int,
                     max_instr_len: int) -> np.ndarray:
    """[I, L] noun-phrase mean-weight rows: row i spreads 1/n over the
    noun-phrase tokens of sub-instruction i, replacing the python double loop
    of the aux loss (vilmodel_cmt.py:750-790).  Rows of imaginations without
    noun phrases (or without a 'True' generated flag) are zero."""
    w = np.zeros((max_imaginations, max_instr_len), np.float32)
    nps = meta.noun_phrase_segs.get(instr_id)
    segs = meta.sub_instr_segs.get(instr_id)
    flags = meta.generated_flags.get(instr_id)
    if nps is None or flags is None:
        return w
    for i, flag in enumerate(flags[:max_imaginations]):
        if flag != "True":
            continue
        token_idxs = []
        for (lo, hi) in nps[i]:
            if segs is not None:
                slo, shi = segs[i]
                assert slo <= lo and hi <= shi, \
                    f"noun phrase outside sub-instruction span ({instr_id})"
            token_idxs.extend(range(lo, min(hi + 1, max_instr_len)))
        if token_idxs:
            w[i, token_idxs] = 1.0 / len(token_idxs)
    return w


def reverie_np_weights(txt_mask: np.ndarray,
                       max_imaginations: int) -> np.ndarray:
    """REVERIE/SOON noun-phrase weights: ONE imagination per instruction,
    aligned to the mean of ALL valid instruction tokens
    (AlignWithContrastiveLossReverie, VLN-DUET/map_nav_src/models/
    vilmodel.py:781-827).  Expressed in the shared weight-matrix form: row 0
    uniform over valid tokens, remaining rows zero."""
    B, L = txt_mask.shape
    w = np.zeros((B, max_imaginations, L), np.float32)
    counts = np.maximum(txt_mask.sum(axis=1, keepdims=True), 1)
    w[:, 0, :] = txt_mask / counts
    return w


def episodes_from_annotations(
    items: list[dict],
    graphs: list[ScanGraph],
    meta: AuxMetadata,
    max_instr_len: int,
    max_gt_path_len: int,
    max_imaginations: int,
    imagine_feats: np.ndarray | None = None,
    imagine_images: np.ndarray | None = None,
    imagine_mask_override: np.ndarray | None = None,
    obj_id_fn=None,
    imagine_feat_dim: int = 768,
    clamp_gt_path: bool = False,
) -> tuple[EpisodeBatch, list[str]]:
    """Annotation dicts -> EpisodeBatch (+ instr_id list for eval joins).

    imagine_mask_override: [B, I] validity mask to use instead of the
    generated-flag-derived one — the v1 imagination format
    (`_create_diffusion_imaginations`, agent_cmt.py:217-246) packs features
    densely with a first-n mask and has no generated-flag JSON.

    clamp_gt_path: overflowing gt paths raise by default (a truncated path
    shifts gt_path[-1] — the teacher/reward goal — onto an intermediate
    node); True clips to the buffer with a warning instead, which only the
    NDH sampled-goal path opts into (goals there are resampled per call and
    scored via end_panos, so a rare clip degrades supervision, not eval)."""
    import warnings
    scan_index = {g.scan_id: s for s, g in enumerate(graphs)}
    id_maps = {g.scan_id: g.id_to_index for g in graphs}
    B = len(items)
    L, P, I = max_instr_len, max_gt_path_len, max_imaginations

    scan = np.zeros(B, np.int32)
    start = np.zeros(B, np.int32)
    heading = np.zeros(B, np.float32)
    gt_path = np.zeros((B, P), np.int32)
    gt_len = np.zeros(B, np.int32)
    txt_ids = np.zeros((B, L), np.int32)
    txt_mask = np.zeros((B, L), bool)
    np_w = np.zeros((B, I, L), np.float32)
    imagine_mask = np.zeros((B, I), bool)
    instr_ids = []
    # r2r_back: annotations carry a 'midstop' viewpoint id per item
    # (R2RBackBatch reads it at VLN-HAMT/finetune_src/r2r/env.py:434-435)
    has_midstop = any("midstop" in item for item in items)
    midstop = np.full(B, -1, np.int32) if has_midstop else None
    # REVERIE/SOON: the grounding target object id (item['objId'], interned
    # to the same int space as WorldTables.obj_ids by obj_id_fn)
    has_obj = any(item.get("objId") is not None for item in items)
    gt_obj = np.zeros(B, np.int32) if has_obj else None
    if obj_id_fn is None:
        def obj_id_fn(raw):
            try:
                return int(raw)
            except (TypeError, ValueError):
                return 0

    for b, item in enumerate(items):
        instr_ids.append(item["instr_id"])
        s = scan_index[item["scan"]]
        idmap = id_maps[item["scan"]]
        scan[b] = s
        path = [idmap[v] for v in item["path"]]
        if len(path) > P:
            # Truncating would silently shift gt_path[-1] (the goal the
            # teacher and reward shaping steer toward) onto an intermediate
            # node and corrupt every DTW-family number.  Long-path variants
            # must pick the sized preset (r4r_config / rxr_config /
            # cvdn_config / soon_config) or raise env.max_gt_path_len.
            if not clamp_gt_path:
                raise ValueError(
                    f"gt path of {item['instr_id']} has {len(path)} nodes "
                    f"but env.max_gt_path_len={P}; use the dataset's config "
                    f"preset (r4r/rxr/cvdn/soon) or raise max_gt_path_len")
            warnings.warn(
                f"clamping gt path of {item['instr_id']} "
                f"({len(path)} > max_gt_path_len={P}); the clipped prefix "
                f"supervises toward an intermediate node", stacklevel=2)
            path = path[:P]
        gt_len[b] = len(path)
        gt_path[b, :len(path)] = path
        gt_path[b, len(path):] = path[-1]
        start[b] = path[0]
        heading[b] = item.get("heading", 0.0)
        enc = item["instr_encoding"][:L]
        txt_ids[b, :len(enc)] = enc
        txt_mask[b, :len(enc)] = True
        if has_midstop and "midstop" in item:
            midstop[b] = idmap[item["midstop"]]
        if has_obj and item.get("objId") is not None:
            gt_obj[b] = obj_id_fn(item["objId"])
        np_w[b] = np_weight_matrix(item["instr_id"], meta, I, L)
        flags = meta.generated_flags.get(item["instr_id"])
        if flags is not None:
            imagine_mask[b, :I] = [f == "True" for f in flags[:I]] + \
                [False] * max(0, I - len(flags))

    if imagine_mask_override is not None:
        imagine_mask = np.asarray(imagine_mask_override, bool)
    if imagine_feats is None:
        imagine_feats = np.zeros((B, I, imagine_feat_dim), np.float32)

    ep = EpisodeBatch(
        scan=scan, start_node=start, start_heading=heading,
        gt_path=gt_path, gt_len=gt_len, txt_ids=txt_ids, txt_mask=txt_mask,
        imagine_feats=imagine_feats, imagine_mask=imagine_mask,
        np_weights=np_w, midstop=midstop, gt_obj_id=gt_obj,
        imagine_images=imagine_images)
    return ep, instr_ids


class RoundRobinSampler:
    """Training batch order: sequential with reshuffle-on-wrap
    (R2RBatch._next_minibatch, env.py:188-204)."""

    def __init__(self, n: int, batch_size: int, seed: int = 0):
        self.n = n
        self.bs = batch_size
        self.rng = np.random.default_rng(seed)
        self.order = self.rng.permutation(n)
        self.ix = 0

    def next_batch(self) -> np.ndarray:
        take = self.order[self.ix: self.ix + self.bs]
        if len(take) < self.bs:
            self.order = self.rng.permutation(self.n)
            self.ix = self.bs - len(take)
            take = np.concatenate([take, self.order[: self.ix]])
        else:
            self.ix += self.bs
        return take


class EvalSampler:
    """Whole-epoch eval order with 'looped' detection
    (BaseAgent.test, agent_base.py:25-49): batches wrap; items seen twice are
    dropped by the caller via the returned fresh-mask."""

    def __init__(self, n: int, batch_size: int):
        self.n = n
        self.bs = batch_size
        self.ix = 0
        self.seen: set[int] = set()

    def __iter__(self):
        self.ix = 0
        self.seen = set()
        while len(self.seen) < self.n:
            idxs = [(self.ix + k) % self.n for k in range(self.bs)]
            self.ix = (self.ix + self.bs) % self.n
            # mark as seen item by item so WITHIN-batch duplicates (bs > n,
            # e.g. after the driver's mesh rounding raised bs above a tiny
            # split) are not fresh twice and never scored twice
            fresh = np.empty(len(idxs), bool)
            for k, i in enumerate(idxs):
                fresh[k] = i not in self.seen
                self.seen.add(i)
            yield np.asarray(idxs), fresh


def ndh_episodes_from_annotations(
    items: list[dict],
    graphs: list[ScanGraph],
    max_instr_len: int,
    max_gt_path_len: int,
    max_imaginations: int,
    rng: np.ndarray | None = None,
    use_player_path: bool = False,
) -> tuple[EpisodeBatch, list[str], list[list[int]]]:
    """NDH (CVDN) episodes: the supervision path is resampled per call —
    the player's recorded path with p=0.5 (when enabled) or the shortest
    path to a random end pano (NDHNavBatch._next_minibatch,
    cvdn/env.py:30-45).  Returns (episodes, instr_ids, end_panos_per_item
    as node indices for goal-progress eval)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    graphs_by_scan = {g.scan_id: g for g in graphs}
    id_maps = {g.scan_id: g.id_to_index for g in graphs}
    resolved = []
    end_panos_all = []
    for item in items:
        g = graphs_by_scan[item["scan"]]
        idmap = id_maps[item["scan"]]
        it = dict(item)
        if "end_panos" in item and item["end_panos"]:
            player = use_player_path and rng.random() > 0.5 and \
                item.get("nav_steps")
            if player:
                it["path"] = item["nav_steps"][item.get("nav_idx", 0):]
            else:
                # goal sampled per call (NDHNavBatch._next_minibatch,
                # cvdn/env.py:30-45); the gt path is the full shortest path
                # to the sampled goal — nDTW/SDTW metrics and DTW reward
                # shaping both score against it, so a [start, end] stub
                # would silently corrupt every DTW-family number
                end = rng.choice(item["end_panos"])
                nodes = shortest_path_nodes(g, idmap[item["start_pano"]],
                                            idmap[end])
                it["path"] = [g.node_ids[n] for n in nodes]
            end_panos_all.append([idmap[p] for p in item["end_panos"]
                                  if p in idmap])
        else:
            it["path"] = [item["start_pano"]]
            end_panos_all.append([idmap[item["start_pano"]]])
        it.setdefault("heading", item.get("start_heading", 0.0))
        it.setdefault("instr_id", str(item.get("inst_idx",
                                               len(resolved))))
        resolved.append(it)
    ep, ids = episodes_from_annotations(
        resolved, graphs, AuxMetadata(), max_instr_len, max_gt_path_len,
        max_imaginations, clamp_gt_path=True)
    return ep, ids, end_panos_all


class RoundRobinSampler:
    """Training batch order: sequential with reshuffle-on-wrap
    (R2RBatch._next_minibatch, env.py:188-204)."""

    def __init__(self, n: int, batch_size: int, seed: int = 0):
        self.n = n
        self.bs = batch_size
        self.rng = np.random.default_rng(seed)
        self.order = self.rng.permutation(n)
        self.ix = 0

    def next_batch(self) -> np.ndarray:
        take = self.order[self.ix: self.ix + self.bs]
        if len(take) < self.bs:
            self.order = self.rng.permutation(self.n)
            self.ix = self.bs - len(take)
            take = np.concatenate([take, self.order[: self.ix]])
        else:
            self.ix += self.bs
        return take


class EvalSampler:
    """Whole-epoch eval order with 'looped' detection
    (BaseAgent.test, agent_base.py:25-49): batches wrap; items seen twice are
    dropped by the caller via the returned fresh-mask."""

    def __init__(self, n: int, batch_size: int):
        self.n = n
        self.bs = batch_size
        self.ix = 0
        self.seen: set[int] = set()

    def __iter__(self):
        self.ix = 0
        self.seen = set()
        while len(self.seen) < self.n:
            idxs = [(self.ix + k) % self.n for k in range(self.bs)]
            self.ix = (self.ix + self.bs) % self.n
            # mark as seen item by item so WITHIN-batch duplicates (bs > n,
            # e.g. after the driver's mesh rounding raised bs above a tiny
            # split) are not fresh twice and never scored twice
            fresh = np.empty(len(idxs), bool)
            for k, i in enumerate(idxs):
                fresh[k] = i not in self.seen
                self.seen.add(i)
            yield np.asarray(idxs), fresh
