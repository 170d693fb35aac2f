"""Navigation metrics: nav/oracle error, SR, oracle SR, SPL, (n/S)DTW, CLS.

Formula-exact rebuild of VLN-HAMT/finetune_src/r2r/env.py:360-425 and
eval_utils.py:74-110, over the compiled distance tables instead of networkx
dicts.  Host-side numpy: metrics run once per validation pass on gathered
trajectories, not in the hot path.  The port's own copy of the JAX package's
metrics module.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

ERROR_MARGIN = 3.0


def path_length(dist: np.ndarray, path: np.ndarray) -> float:
    return float(sum(dist[a, b] for a, b in zip(path[:-1], path[1:])))


def cal_dtw(dist: np.ndarray, prediction, reference,
            success: float | None = None, threshold: float = ERROR_MARGIN):
    """Dynamic time warping family (eval_utils.py:74-94)."""
    P, R = len(prediction), len(reference)
    m = np.full((P + 1, R + 1), np.inf)
    m[0, 0] = 0.0
    for i in range(1, P + 1):
        for j in range(1, R + 1):
            best = min(m[i - 1, j], m[i, j - 1], m[i - 1, j - 1])
            m[i, j] = dist[prediction[i - 1], reference[j - 1]] + best
    dtw = m[P, R]
    ndtw = float(np.exp(-dtw / (threshold * R)))
    if success is None:
        success = float(dist[prediction[-1], reference[-1]] < threshold)
    return {"DTW": float(dtw), "nDTW": ndtw, "SDTW": success * ndtw}


def cal_cls(dist: np.ndarray, prediction, reference,
            threshold: float = ERROR_MARGIN) -> float:
    """Coverage weighted by length score (eval_utils.py:96-110)."""
    coverage = float(np.mean([
        np.exp(-min(dist[u, v] for v in prediction) / threshold)
        for u in reference
    ]))
    expected = coverage * path_length(dist, reference)
    pl = path_length(dist, prediction)
    score = expected / (expected + abs(expected - pl))
    return coverage * score


def eval_item(dist: np.ndarray, path, gt_path,
              threshold: float = ERROR_MARGIN) -> dict:
    """Per-trajectory scores (env.py:371-396)."""
    assert path[0] == gt_path[0], "trajectories must include the start"
    nearest = min(path, key=lambda v: dist[v, gt_path[-1]])
    scores = {
        "nav_error": float(dist[path[-1], gt_path[-1]]),
        "oracle_error": float(dist[nearest, gt_path[-1]]),
        "trajectory_steps": len(path) - 1,
        "trajectory_lengths": path_length(dist, path),
    }
    gt_length = path_length(dist, gt_path)
    scores["success"] = float(scores["nav_error"] < threshold)
    scores["spl"] = scores["success"] * gt_length / max(
        scores["trajectory_lengths"], gt_length, 0.01)
    scores["oracle_success"] = float(scores["oracle_error"] < threshold)
    scores.update(cal_dtw(dist, path, gt_path, scores["success"], threshold))
    scores["CLS"] = cal_cls(dist, path, gt_path, threshold)
    return scores


def eval_batch(dist_tables: np.ndarray, scans: np.ndarray,
               paths: list[list[int]], gt_paths: list[list[int]],
               instr_ids=None, threshold: float = ERROR_MARGIN):
    """Evaluate many trajectories; dist_tables is [S, N, N]."""
    metrics = defaultdict(list)
    for i, (path, gt) in enumerate(zip(paths, gt_paths)):
        scores = eval_item(dist_tables[scans[i]], path, gt, threshold)
        for k, v in scores.items():
            metrics[k].append(v)
        metrics["instr_id"].append(instr_ids[i] if instr_ids is not None else i)
    return summarize(metrics), metrics


def summarize(metrics) -> dict:
    """Aggregates in the reference's reporting units (env.py:413-424)."""
    return {
        "steps": float(np.mean(metrics["trajectory_steps"])),
        "lengths": float(np.mean(metrics["trajectory_lengths"])),
        "nav_error": float(np.mean(metrics["nav_error"])),
        "oracle_error": float(np.mean(metrics["oracle_error"])),
        "sr": float(np.mean(metrics["success"]) * 100),
        "oracle_sr": float(np.mean(metrics["oracle_success"]) * 100),
        "spl": float(np.mean(metrics["spl"]) * 100),
        "nDTW": float(np.mean(metrics["nDTW"]) * 100),
        "SDTW": float(np.mean(metrics["SDTW"]) * 100),
        "CLS": float(np.mean(metrics["CLS"]) * 100),
    }


def trajectories_from_rollout(path_nodes: np.ndarray,
                              path_len: np.ndarray) -> list[list[int]]:
    """[B, T+1] padded node ids + lengths -> list of node-id paths."""
    return [list(path_nodes[b, :path_len[b]]) for b in range(len(path_len))]
