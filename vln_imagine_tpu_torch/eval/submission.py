"""Leaderboard submission + per-item metric dumps.

Rebuild of the valid() output files (VLN-HAMT/finetune_src/r2r/main.py:
402-421): `submit_<env>.json` holds [{'instr_id', 'trajectory':
[[viewpoint, heading, elevation], ...]}] and
`individual_metrics_<env>.json` the per-item score lists.  The port's own
copy of the JAX package's module.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from vln_imagine_tpu_torch.envx.compiler import ScanGraph, heading_elevation


def trajectory_with_poses(graph: ScanGraph, node_path: list[int],
                          start_heading: float) -> list[list]:
    """[(viewpoint_id, heading, elevation)] — the pose after each step is the
    discretized view of the arrival edge (make_equiv_action's terminal pose,
    agent_cmt.py:336-369)."""
    per_row = 12
    snap = lambda h: round(h / (2 * math.pi / per_row)) % per_row * \
        (2 * math.pi / per_row)  # noqa: E731
    out = [[graph.node_ids[node_path[0]], snap(start_heading), 0.0]]
    for a, b in zip(node_path[:-1], node_path[1:]):
        h, e = heading_elevation(graph.xyz[a], graph.xyz[b])
        out.append([graph.node_ids[b], snap(h),
                    round(e / math.radians(30.0)) * math.radians(30.0)])
    return out


def write_submission(path: str, graphs: list[ScanGraph],
                     scans: np.ndarray, node_paths: list[list[int]],
                     instr_ids: list, start_headings: np.ndarray,
                     details: list[dict] | None = None,
                     pred_obj_ids: list | None = None):
    """details (--detailed_output, agent.py:597-601 / agent_base.py:27-33):
    per item a {node_index: stop_logit} map, emitted per viewpoint id as
    {'stop_prob': float}.  pred_obj_ids (REVERIE/SOON): the grounded object
    id per item, emitted as the reference's 'predObjId' string field
    (reverie/agent.py:24,193 — str(None) when nothing was grounded)."""
    preds = []
    for i, p in enumerate(node_paths):
        g = graphs[int(scans[i])]
        preds.append({
            "instr_id": instr_ids[i],
            "trajectory": trajectory_with_poses(g, list(p),
                                                float(start_headings[i])),
        })
        if details is not None:
            preds[-1]["details"] = {
                g.node_ids[n]: {"stop_prob": s}
                for n, s in details[i].items()}
        if pred_obj_ids is not None:
            o = pred_obj_ids[i]
            preds[-1]["predObjId"] = str(None) if o is None or o < 0 \
                else str(int(o))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(preds, f)
    return preds


def write_individual_metrics(path: str, metrics: dict):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({k: (list(map(float, v)) if k != "instr_id" else list(v))
                   for k, v in metrics.items()}, f)
