"""Task variants as dataset / teacher / eval plugins.

The reference carries six near-identical agent/env directory copies
(VLN-HAMT/finetune_src/{r2r,cvdn,reverie}, VLN-DUET/map_nav_src/{r2r,r4r via
flags,reverie,soon}).  The rebuilt framework expresses the variants as data +
plugin behaviour on the shared compiled environment and agents:

- r2r        : baseline (envx + eval.metrics)
- r2r_back   : midstop objective (R2RBackBatch, VLN-HAMT .../r2r/env.py:
               428-536) — success requires passing near the midstop AND
               ending near the goal
- r4r / rxr  : longer non-shortest paths; same metrics with nDTW emphasis,
               teacher follows the annotated path (our time-indexed teacher
               already does); rxr additionally switches tokenizer/text config
- cvdn (NDH) : multiple goal panos, goal-progress metric
               (VLN-HAMT/finetune_src/cvdn/env.py:91-130)
- reverie    : object grounding; nav success = reach any viewpoint where the
               target object is visible, RGS/RGSPL for the chosen object
               (VLN-DUET/map_nav_src/reverie/env.py:356-380)
- soon       : REVERIE-style eval over SOON annotations
               (VLN-DUET/map_nav_src/soon/*)

The port's own copy of the JAX package's module: host-side numpy scoring on
the port's `eval/metrics.py`.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from vln_imagine_tpu_torch.eval.metrics import (
    ERROR_MARGIN,
    cal_cls,
    cal_dtw,
    eval_item,
    path_length,
)


# --------------------------------------------------------------- r2r_back
def eval_item_r2r_back(dist: np.ndarray, path, gt_path, midstop, gt_midstop,
                       threshold: float = ERROR_MARGIN) -> dict:
    """R2RBackBatch._eval_item (env.py:480-507): success only when the
    declared midstop is within the margin of the annotated midstop AND the
    final position is within the margin of the goal."""
    assert path[0] == gt_path[0]
    scores = {
        "nav_error": float(dist[path[-1], gt_path[-1]]),
        "trajectory_steps": len(path) - 1,
        "trajectory_lengths": path_length(dist, path),
    }
    gt_length = path_length(dist, gt_path)
    success = 0.0
    if midstop is not None:
        if dist[midstop, gt_midstop] <= threshold and \
                dist[path[-1], gt_path[-1]] <= threshold:
            success = 1.0
    scores["success"] = success
    scores["spl"] = success * gt_length / max(scores["trajectory_lengths"],
                                              gt_length, 0.01)
    scores.update(cal_dtw(dist, path, gt_path, success, threshold))
    scores["CLS"] = cal_cls(dist, path, gt_path, threshold)
    return scores


# ------------------------------------------------------------------- cvdn
def eval_item_ndh(dist: np.ndarray, path, end_panos: Sequence[int]) -> dict:
    """NDH dialog navigation (cvdn/env.py:91-109): success = reach any goal
    pano; gp = progress towards the nearest goal pano."""
    end = list(end_panos)
    scores = {
        "trajectory_steps": len(path) - 1,
        "trajectory_lengths": path_length(dist, path),
    }
    gt_length = float(min(dist[path[0], e] for e in end))
    scores["success"] = float(path[-1] in set(end))
    scores["oracle_success"] = float(any(x in set(end) for x in path))
    scores["spl"] = scores["success"] * gt_length / max(
        scores["trajectory_lengths"], gt_length, 0.01)
    scores["gp"] = gt_length - float(min(dist[path[-1], e] for e in end))
    return scores


# ---------------------------------------------------------------- reverie
def eval_item_reverie(dist: np.ndarray, path, gt_path,
                      goal_viewpoints: Sequence[int],
                      pred_obj, gt_obj) -> dict:
    """REVERIE object navigation (reverie/env.py:356-380): nav success =
    end at any viewpoint from which the target object is visible; RGS =
    grounded the right object, RGSPL = RGS weighted by path efficiency."""
    assert gt_path[0] == path[0]
    goal = set(goal_viewpoints)
    assert goal, "object has no visible viewpoints"
    scores = {
        "trajectory_steps": len(path) - 1,
        "trajectory_lengths": path_length(dist, path),
    }
    gt_length = path_length(dist, gt_path)
    scores["success"] = float(path[-1] in goal)
    scores["oracle_success"] = float(any(x in goal for x in path))
    scores["spl"] = scores["success"] * gt_length / max(
        scores["trajectory_lengths"], gt_length, 0.01)
    scores["rgs"] = float(str(pred_obj) == str(gt_obj))
    scores["rgspl"] = scores["rgs"] * gt_length / max(
        scores["trajectory_lengths"], gt_length, 0.01)
    return scores


def eval_item_soon(dist, path, gt_path, goal_viewpoints, pred_obj, gt_obj):
    """SOON shares REVERIE's scoring (soon/env.py)."""
    return eval_item_reverie(dist, path, gt_path, goal_viewpoints, pred_obj,
                             gt_obj)


# ----------------------------------------------------------------- registry
@dataclass(frozen=True)
class VariantSpec:
    name: str
    eval_kind: str              # 'r2r' | 'r2r_back' | 'ndh' | 'object'
    teacher: str                # 'time_indexed' | 'shortest' | 'spl_expert'
    tokenizer: str = "bert-base-uncased"
    max_instr_len: int = 60
    uses_objects: bool = False
    notes: str = ""


VARIANTS: dict[str, VariantSpec] = {
    "r2r": VariantSpec("r2r", "r2r", "time_indexed"),
    "r2r_back": VariantSpec("r2r_back", "r2r_back", "time_indexed",
                            notes="midstop declared at the first stop"),
    "r4r": VariantSpec("r4r", "r2r", "time_indexed", max_instr_len=120,
                       notes="non-shortest gt paths; nDTW-primary"),
    "rxr": VariantSpec("rxr", "r2r", "time_indexed",
                       tokenizer="xlm-roberta-base", max_instr_len=250,
                       notes="multilingual; xlm tokenizer"),
    "cvdn": VariantSpec("cvdn", "ndh", "shortest", max_instr_len=120,
                        notes="dialog history text; goal-progress metric"),
    "reverie": VariantSpec("reverie", "object", "spl_expert",
                           max_instr_len=80, uses_objects=True),
    "soon": VariantSpec("soon", "object", "spl_expert", max_instr_len=120,
                        uses_objects=True),
}


def eval_batch_variant(
    variant: str,
    dist_tables: np.ndarray,
    scans: np.ndarray,
    paths: list[list[int]],
    gt_paths: list[list[int]] | None = None,
    midstops: list | None = None,
    gt_midstops: list | None = None,
    end_panos: list | None = None,
    goal_viewpoints: list | None = None,
    pred_objs: list | None = None,
    gt_objs: list | None = None,
    instr_ids=None,
):
    """Variant-dispatched scoring over a batch of trajectories."""
    spec = VARIANTS[variant]
    metrics = defaultdict(list)
    for i, path in enumerate(paths):
        d = dist_tables[scans[i]]
        if spec.eval_kind == "r2r":
            s = eval_item(d, path, gt_paths[i])
        elif spec.eval_kind == "r2r_back":
            s = eval_item_r2r_back(d, path, gt_paths[i], midstops[i],
                                   gt_midstops[i])
        elif spec.eval_kind == "ndh":
            s = eval_item_ndh(d, path, end_panos[i])
        elif spec.eval_kind == "object":
            s = eval_item_reverie(d, path, gt_paths[i], goal_viewpoints[i],
                                  pred_objs[i], gt_objs[i])
        else:
            raise ValueError(spec.eval_kind)
        for k, v in s.items():
            metrics[k].append(v)
        metrics["instr_id"].append(instr_ids[i] if instr_ids is not None
                                   else i)
    avg = {}
    for k, v in metrics.items():
        if k == "instr_id":
            continue
        scale = 100.0 if k in ("success", "oracle_success", "spl", "nDTW",
                               "SDTW", "CLS", "rgs", "rgspl") else 1.0
        avg[k if scale == 1.0 else {"success": "sr",
                                    "oracle_success": "oracle_sr"}.get(k, k)
            ] = float(np.mean(v) * scale)
    return avg, metrics
