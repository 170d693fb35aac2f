"""Array world model: the Matterport viewpoint graph as dense per-scan tables.

The reference drives one MatterSim simulator per batch slot in graph-only
mode (VLN-HAMT/finetune_src/r2r/env.py:50-61).  Here the world is compiled
offline into fixed-shape arrays, so a batched episode (observation assembly,
action selection, state transition) is tensor code on the device.

The dataclasses hold numpy arrays as the compiler and the synthetic
generator build them; `.to(device)` returns a copy holding tensors.

Shape glossary: S scans, N max nodes per scan, K max candidates (graph
degree), V discretized views (36), P max ground-truth path length, L max
instruction tokens, I max imaginations, B batch.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

INF = 1.0e9


class _Arrays:
    """replace() and to(device) for a frozen dataclass of arrays."""

    def replace(self, **kw: Any):
        return dataclasses.replace(self, **kw)

    def to(self, device):
        def move(x):
            if x is None:
                return None
            return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                   else x).to(device)
        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name))
            for f in dataclasses.fields(self)})


@dataclass(frozen=True)
class WorldTables(_Arrays):
    """Static per-scan navigation tables (compiled once, device-resident)."""

    node_xyz: Any        # [S, N, 3] f32 viewpoint positions
    node_valid: Any      # [S, N] bool
    adj: Any             # [S, N, K] i32 neighbour node id (0 if invalid)
    adj_valid: Any       # [S, N, K] bool
    cand_pointid: Any    # [S, N, K] i32 closest discretized view index
    cand_heading: Any    # [S, N, K] f32 absolute heading to neighbour
    cand_elevation: Any  # [S, N, K] f32 absolute elevation to neighbour
    dist: Any            # [S, N, N] f32 all-pairs geodesic distance
    next_hop: Any        # [S, N, N] i32 next node on shortest path
    hops: Any            # [S, N, N] i32 number of edges on shortest path
    feat: Optional[Any] = None  # [S, N, V, Df] f32 view features
    # REVERIE/SOON object annotations (None for object-free tasks)
    obj_feat: Optional[Any] = None   # [S, N, Ko, Do] f32
    obj_ang: Optional[Any] = None    # [S, N, Ko, 2] heading/elev
    obj_valid: Optional[Any] = None  # [S, N, Ko] bool
    obj_ids: Optional[Any] = None    # [S, N, Ko] i32 dataset obj id
    obj_pos: Optional[Any] = None    # [S, N, Ko, 5] normalized bbox
    # (x1,y1,x2,y2,area — get_obj_local_pos, reverie/data_utils.py:25-31)

    @property
    def max_objects(self) -> int:
        return 0 if self.obj_feat is None else self.obj_feat.shape[2]

    @property
    def num_scans(self) -> int:
        return self.node_xyz.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.node_xyz.shape[1]

    @property
    def max_candidates(self) -> int:
        return self.adj.shape[2]

    @property
    def views(self) -> int:
        return self.feat.shape[2] if self.feat is not None else 36


@dataclass(frozen=True)
class EpisodeBatch(_Arrays):
    """Per-episode static inputs (one R2R instruction per batch slot)."""

    scan: Any           # [B] i32 scan index
    start_node: Any     # [B] i32
    start_heading: Any  # [B] f32 (radians, pre-snap)
    gt_path: Any        # [B, P] i32, padded by repeating the goal
    gt_len: Any         # [B] i32
    txt_ids: Any        # [B, L] i32
    txt_mask: Any       # [B, L] bool
    imagine_feats: Any  # [B, I, Df] f32
    imagine_mask: Any   # [B, I] bool (generated-flag per sub-instruction)
    np_weights: Any     # [B, I, L] f32 noun-phrase mean weights
    midstop: Optional[Any] = None    # [B] i32 r2r_back turn-around node
    gt_obj_id: Optional[Any] = None  # [B] i32 REVERIE/SOON target object

    @property
    def batch(self) -> int:
        return self.scan.shape[0]

    @property
    def goal(self):
        idx = self.gt_len - 1
        if torch.is_tensor(self.gt_path):
            return self.gt_path.gather(1, idx.long()[:, None])[:, 0]
        return self.gt_path[np.arange(self.batch), idx]


@dataclass(frozen=True)
class EnvState(_Arrays):
    """Dynamic rollout state: fixed-shape tensors updated every step."""

    node: torch.Tensor        # [B] i32 current viewpoint
    view_index: torch.Tensor  # [B] i32 current discretized view (0..V-1)
    ended: torch.Tensor       # [B] bool
    step: int                 # global time step
    path_nodes: torch.Tensor  # [B, T+1] i32 visited node per action step
    path_len: torch.Tensor    # [B] i32 number of valid entries in path_nodes


def snap_heading_to_view(heading: torch.Tensor, views: int = 36) -> torch.Tensor:
    """Discretize an arbitrary start heading onto the horizon row, as MatterSim
    does with setDiscretizedViewingAngles(True) (env.py:57)."""
    per_row = views // 3
    col = torch.round(heading / (2.0 * math.pi / per_row)).to(torch.int32) % per_row
    return per_row + col  # horizon row (elevation 0)
