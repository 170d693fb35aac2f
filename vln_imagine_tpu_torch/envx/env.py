"""Batched environment, HAMT eval half: (tables, state) -> tensors transforms.

Everything here is shape-static tensor code on the tables' device.  These
functions replace the per-step host work of the reference:

- observation assembly `_get_obs` + `make_candidate`
  (VLN-HAMT/finetune_src/r2r/env.py:221-342)
- feature packing `_cand_pano_feature_variable` (r2r/agent_cmt.py:130-176)
- simulator stepping `make_equiv_action` (agent_cmt.py:336-369): the
  micro-turns collapse into one table lookup, since only the terminal
  discretized pose matters

Observation token layout: slots [0..K-1] candidates, slot K = STOP, slots
[K+1..K+V] the panorama views (views already claimed by a candidate are
masked out).

Every gather index is clipped or valid by construction: torch raises on an
out-of-range index where JAX clamps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from vln_imagine_tpu_torch.envx.tables import (
    EnvState,
    EpisodeBatch,
    WorldTables,
    snap_heading_to_view,
)
from vln_imagine_tpu_torch.ops.angles import (
    angle_feature,
    view_elevation,
    view_heading,
)


class HamtObs(NamedTuple):
    img: torch.Tensor         # [B, T_obs, Df]
    ang: torch.Tensor         # [B, T_obs, A]
    nav_types: torch.Tensor   # [B, T_obs] i32 (0 pano, 1 candidate, 2 stop)
    valid: torch.Tensor       # [B, T_obs] bool
    cand_valid: torch.Tensor  # [B, K] bool
    stop_slot: int            # == K


def obs_tokens(max_candidates: int, views: int) -> int:
    return max_candidates + 1 + views


def reset(tables: WorldTables, ep: EpisodeBatch, max_action_len: int) -> EnvState:
    B = ep.batch
    view = snap_heading_to_view(ep.start_heading, tables.views)
    path = torch.zeros((B, max_action_len + 1), dtype=torch.int32,
                       device=ep.start_node.device)
    path[:, 0] = ep.start_node
    return EnvState(
        node=ep.start_node,
        view_index=view,
        ended=torch.zeros((B,), dtype=torch.bool, device=path.device),
        step=0,
        path_nodes=path,
        path_len=torch.ones((B,), dtype=torch.int32, device=path.device),
    )


def _gather_sn(table: torch.Tensor, scan: torch.Tensor, node: torch.Tensor):
    """table[S, N, ...] gathered at per-item (scan, node) -> [B, ...]."""
    return table[scan.long(), node.long()]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for x [B, K, ...] and idx [B] -> [B, ...]."""
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


def candidate_info(tables: WorldTables, ep: EpisodeBatch, state: EnvState):
    """Per-candidate neighbour id / validity / view id / absolute angles."""
    scan, node = ep.scan, state.node
    return (
        _gather_sn(tables.adj, scan, node),
        _gather_sn(tables.adj_valid, scan, node),
        _gather_sn(tables.cand_pointid, scan, node),
        _gather_sn(tables.cand_heading, scan, node),
        _gather_sn(tables.cand_elevation, scan, node),
    )


def pano_rel_angles(view_index: torch.Tensor, views: int,
                    angle_feat_size: int) -> torch.Tensor:
    """[B, V, A] angle features of the V views relative to the current view's
    heading (elevation absolute), get_all_point_angle_feature semantics
    (data_utils.py:506-535)."""
    v = torch.arange(views, dtype=torch.int32, device=view_index.device)
    abs_h = view_heading(v, views)[None, :]
    abs_e = view_elevation(v, views)[None, :]
    base_h = view_heading(view_index, views)[:, None]
    return angle_feature(abs_h - base_h, abs_e, angle_feat_size)


def observe_hamt(tables: WorldTables, ep: EpisodeBatch, state: EnvState,
                 angle_feat_size: int = 4) -> HamtObs:
    """Build the fixed-layout observation token bank for one step."""
    if tables.feat is None:
        raise ValueError("observe_hamt needs view features")
    B = ep.batch
    V = tables.views
    K = tables.max_candidates
    Df = tables.feat.shape[-1]

    _, adj_valid, pointid, c_head, c_elev = candidate_info(tables, ep, state)
    node_feat = _gather_sn(tables.feat, ep.scan, state.node)  # [B, V, Df]

    base_h = view_heading(state.view_index, V)[:, None]
    cand_img = torch.gather(node_feat, 1,
                            pointid.long()[:, :, None].expand(B, K, Df))
    cand_ang = angle_feature(c_head - base_h, c_elev, angle_feat_size)
    cand_img = torch.where(adj_valid[:, :, None], cand_img, 0.0)
    cand_ang = torch.where(adj_valid[:, :, None], cand_ang, 0.0)

    pano_ang = pano_rel_angles(state.view_index, V, angle_feat_size)
    # views claimed by at least one valid candidate are masked from the pano set
    onehot = F.one_hot(pointid.long(), V).bool()  # [B, K, V]
    used = torch.any(onehot & adj_valid[:, :, None], dim=1)  # [B, V]

    A = cand_ang.shape[-1]
    img = torch.cat([cand_img, cand_img.new_zeros((B, 1, Df)), node_feat], dim=1)
    ang = torch.cat([cand_ang, cand_ang.new_zeros((B, 1, A)), pano_ang], dim=1)
    nav = torch.cat([adj_valid.to(torch.int32),
                     torch.full((B, 1), 2, dtype=torch.int32, device=img.device),
                     torch.zeros((B, V), dtype=torch.int32, device=img.device)],
                    dim=1)
    valid = torch.cat([adj_valid,
                       torch.ones((B, 1), dtype=torch.bool, device=img.device),
                       ~used], dim=1)
    return HamtObs(img=img, ang=ang, nav_types=nav, valid=valid,
                   cand_valid=adj_valid, stop_slot=K)


def history_inputs(tables: WorldTables, ep: EpisodeBatch, state: EnvState,
                   action_slot: torch.Tensor, angle_feat_size: int = 4):
    """Inputs for the per-step history embedding (agent_cmt.py:198-215,589-594):
    current-view feature, full pano features + relative angles, and the chosen
    candidate's angle feature as prev-action angle (zero on stop)."""
    V = tables.views
    node_feat = _gather_sn(tables.feat, ep.scan, state.node)
    hist_img = _take(node_feat, state.view_index)
    pano_ang = pano_rel_angles(state.view_index, V, angle_feat_size)

    _, adj_valid, _, c_head, c_elev = candidate_info(tables, ep, state)
    base_h = view_heading(state.view_index, V)[:, None]
    cand_ang = angle_feature(c_head - base_h, c_elev, angle_feat_size)
    K = adj_valid.shape[1]
    slot = torch.clamp(action_slot, 0, K - 1)  # stop / -1 slots read slot 0..K-1
    is_move = (action_slot >= 0) & (action_slot < K)
    prev_act_angle = torch.where(is_move[:, None], _take(cand_ang, slot), 0.0)
    return hist_img, node_feat, pano_ang, prev_act_angle


def step_hamt(tables: WorldTables, ep: EpisodeBatch, state: EnvState,
              action_slot: torch.Tensor) -> EnvState:
    """Apply candidate-slot actions.  slot == K (stop) or ended items hold
    position; moving items jump to the neighbour and adopt its closest-view
    pose, the terminal pose of make_equiv_action's turn sequence
    (agent_cmt.py:336-369)."""
    adj, adj_valid, pointid, _, _ = candidate_info(tables, ep, state)
    K = adj.shape[1]
    slot = torch.clamp(action_slot, 0, K - 1)
    tgt_node = _take(adj, slot)
    tgt_view = _take(pointid, slot)
    valid_move = (_take(adj_valid, slot) & (action_slot >= 0)
                  & (action_slot < K) & ~state.ended)

    node = torch.where(valid_move, tgt_node, state.node)
    view = torch.where(valid_move, tgt_view, state.view_index)
    new_len = torch.where(valid_move, state.path_len + 1, state.path_len)
    cols = torch.arange(state.path_nodes.shape[1], device=node.device)
    path = torch.where((cols[None, :] == state.path_len[:, None])
                       & valid_move[:, None],
                       node[:, None], state.path_nodes)
    ended = state.ended | (action_slot == K) | (action_slot < 0)
    return state.replace(node=node, view_index=view, ended=ended,
                         step=state.step + 1, path_nodes=path, path_len=new_len)


def distance_to_goal(tables: WorldTables, ep: EpisodeBatch,
                     node: torch.Tensor) -> torch.Tensor:
    return tables.dist[ep.scan.long(), node.long(), ep.goal.long()]
