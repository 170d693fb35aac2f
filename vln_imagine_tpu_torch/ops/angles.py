"""Discretized-viewpoint angle features, without a simulator.

View index ``ix`` in [0, 36) has absolute heading ``(ix % 12) * 30deg`` and
elevation ``(ix // 12 - 1) * 30deg`` (VLN-HAMT/finetune_src/r2r/env.py:76-79).
The 4-d angle feature is ``[sin(h), cos(h), sin(e), cos(e)]`` tiled to
``angle_feat_size`` (data_utils.py:481-484).
"""

from __future__ import annotations

import math

import numpy as np
import torch

RAD30 = math.radians(30.0)


def view_heading(view_index, views: int = 36):
    """Absolute heading (radians) of a discretized view index."""
    per_row = views // 3
    return (view_index % per_row) * (2.0 * math.pi / per_row)


def view_elevation(view_index, views: int = 36):
    """Absolute elevation (radians): -30 / 0 / +30 degrees by row."""
    per_row = views // 3
    return (view_index // per_row - 1) * RAD30


def angle_feature(heading: torch.Tensor, elevation: torch.Tensor,
                  angle_feat_size: int = 4) -> torch.Tensor:
    """[sin h, cos h, sin e, cos e] tiled to angle_feat_size; last-dim output."""
    heading, elevation = torch.broadcast_tensors(heading, elevation)
    base = torch.stack([torch.sin(heading), torch.cos(heading),
                        torch.sin(elevation), torch.cos(elevation)], dim=-1)
    reps = angle_feat_size // 4
    if reps > 1:
        base = torch.cat([base] * reps, dim=-1)
    return base


def all_point_angle_feature(angle_feat_size: int = 4, views: int = 36) -> np.ndarray:
    """[views, views, angle_feat_size]: for each base view b, the angle
    features of every view relative to b's heading (elevation absolute),
    as get_all_point_angle_feature (data_utils.py:531-535)."""
    ix = np.arange(views)
    per_row = views // 3
    abs_heading = (ix % per_row) * (2.0 * math.pi / per_row)
    abs_elev = (ix // per_row - 1) * RAD30
    out = np.zeros((views, views, angle_feat_size), np.float32)
    for b in range(views):
        base_heading = (b % per_row) * (2.0 * math.pi / per_row)
        h = abs_heading - base_heading
        feat = np.stack([np.sin(h), np.cos(h), np.sin(abs_elev),
                         np.cos(abs_elev)], axis=-1)
        out[b] = np.concatenate([feat] * (angle_feat_size // 4), axis=-1)
    return out
