"""Batched environment of both agents: (tables, state) -> tensors transforms.

Everything here is shape-static tensor code on the tables' device.  These
functions replace the per-step host work of the reference:

- observation assembly `_get_obs` + `make_candidate`
  (VLN-HAMT/finetune_src/r2r/env.py:221-342)
- feature packing `_cand_pano_feature_variable` (r2r/agent_cmt.py:130-176)
- simulator stepping `make_equiv_action` (agent_cmt.py:336-369): the
  micro-turns collapse into one table lookup, since only the terminal
  discretized pose matters
- the gt-path teacher `_teacher_action` (env.py:293-307) and the nDTW of
  the reward shaping (eval_utils.py:74-94), the latter as an incremental
  DTW row

HAMT observation token layout: slots [0..K-1] candidates, slot K = STOP,
slots [K+1..K+V] the panorama views (views already claimed by a candidate
are masked out).  DUET's pano bank (`observe_duet`) has no STOP slot, and
`rel_pos_features` gives its map and viewpoint position features.

Every gather index is clipped or valid by construction: torch raises on an
out-of-range index where JAX clamps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from vln_imagine_tpu_torch.envx.tables import (
    INF,
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
from vln_imagine_tpu_torch.utils.spans import span


class HamtObs(NamedTuple):
    img: torch.Tensor         # [B, T_obs, Df]
    ang: torch.Tensor         # [B, T_obs, A]
    nav_types: torch.Tensor   # [B, T_obs] i32 (0 pano, 1 candidate, 2 stop)
    valid: torch.Tensor       # [B, T_obs] bool
    cand_valid: torch.Tensor  # [B, K] bool
    stop_slot: int            # == K
    # REVERIE object segment (separate token bank, NavRefCMT
    # `_object_variable` reverie/agent.py:125-139)
    obj_img: Optional[torch.Tensor] = None    # [B, Ko, Do] (obj feature dim,
    # NOT padded to the view dim — NavRef's obj_linear is [Do -> H])
    obj_ang: Optional[torch.Tensor] = None    # [B, Ko, A]
    obj_ids: Optional[torch.Tensor] = None    # [B, Ko] i32
    obj_valid: Optional[torch.Tensor] = None  # [B, Ko] bool
    obj_pos: Optional[torch.Tensor] = None    # [B, Ko, 5] normalized bbox


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

    obj_img = obj_ang = obj_ids = obj_valid = obj_pos = None
    if tables.obj_feat is not None:
        o_feat = _gather_sn(tables.obj_feat, ep.scan, state.node)
        o_ang = _gather_sn(tables.obj_ang, ep.scan, state.node)
        obj_valid = _gather_sn(tables.obj_valid, ep.scan, state.node)
        obj_ids = _gather_sn(tables.obj_ids, ep.scan, state.node)
        # object features keep their OWN dim: NavRefCMT's obj img_linear is
        # [obj_feat_size -> H] (vlnbert_navref.py:17)
        obj_img = o_feat * obj_valid[:, :, None]
        obj_ang = angle_feature(o_ang[..., 0] - base_h, o_ang[..., 1],
                                angle_feat_size)
        if tables.obj_pos is not None:
            obj_pos = (_gather_sn(tables.obj_pos, ep.scan, state.node)
                       * obj_valid[:, :, None])
    return HamtObs(img=img, ang=ang, nav_types=nav, valid=valid,
                   cand_valid=adj_valid, stop_slot=K,
                   obj_img=obj_img, obj_ang=obj_ang, obj_ids=obj_ids,
                   obj_valid=obj_valid, obj_pos=obj_pos)


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


class DuetObs(NamedTuple):
    img: torch.Tensor         # [B, K+V, Df] candidate and view features
    loc: torch.Tensor         # [B, T_pano, A+3] (angle feats + [1,1,1] box)
    nav_types: torch.Tensor   # [B, T_pano] i32 (0 pano, 1 candidate, 2 object)
    valid: torch.Tensor       # [B, T_pano] bool
    cand_nodes: torch.Tensor  # [B, K] neighbour node id
    cand_valid: torch.Tensor  # [B, K] bool
    obj_ids: Optional[torch.Tensor] = None    # [B, Ko] dataset object ids
    obj_valid: Optional[torch.Tensor] = None  # [B, Ko] bool
    # object features at their own width Do, zero where invalid
    obj_img: Optional[torch.Tensor] = None    # [B, Ko, Do]


def observe_duet(tables: WorldTables, ep: EpisodeBatch, state: EnvState,
                 angle_feat_size: int = 4) -> DuetObs:
    """DUET pano token bank (no STOP token; the local branch prepends it):
    slots [0..K-1] candidates, [K..K+V-1] panorama views; views claimed by a
    candidate are masked (agent.py:53-96 `_panorama_feature_variable`).
    REVERIE/SOON object tokens follow the views: T_pano = K + V + Ko.  `img`
    holds the K + V view tokens' features and `obj_img` the objects' at
    their own width, which the model embeds through its own projection
    where it differs from the view width (vilmodel.py:1087-1131)."""
    if tables.feat is None:
        raise ValueError("observe_duet needs view features")
    B = ep.batch
    V = tables.views
    Df = tables.feat.shape[-1]

    adj, adj_valid, pointid, c_head, c_elev = candidate_info(tables, ep, state)
    K = adj_valid.shape[1]
    node_feat = _gather_sn(tables.feat, ep.scan, state.node)

    base_h = view_heading(state.view_index, V)[:, None]
    cand_img = torch.gather(node_feat, 1,
                            pointid.long()[:, :, None].expand(B, K, Df))
    cand_ang = angle_feature(c_head - base_h, c_elev, angle_feat_size)
    cand_img = torch.where(adj_valid[:, :, None], cand_img, 0.0)
    cand_ang = torch.where(adj_valid[:, :, None], cand_ang, 0.0)

    pano_ang = pano_rel_angles(state.view_index, V, angle_feat_size)
    onehot = F.one_hot(pointid.long(), V).bool()
    used = torch.any(onehot & adj_valid[:, :, None], dim=1)

    img = torch.cat([cand_img, node_feat], dim=1)
    ang = torch.cat([cand_ang, pano_ang], dim=1)
    box = torch.ones(ang.shape[:2] + (3,), dtype=ang.dtype, device=ang.device)
    loc = torch.cat([ang, box], dim=-1)  # [1,1,1] box (agent.py:77)
    nav = torch.cat([adj_valid.to(torch.int32),
                     torch.zeros((B, V), dtype=torch.int32, device=img.device)],
                    dim=1)
    valid = torch.cat([adj_valid, ~used], dim=1)

    obj_ids = obj_valid = obj_img = None
    if tables.obj_feat is not None:
        # REVERIE/SOON: object tokens after the views, nav type 2
        # (reverie agent `_object_variable`), features at their own width
        with span("env.objects"):
            o_feat = _gather_sn(tables.obj_feat, ep.scan, state.node)
            o_ang = _gather_sn(tables.obj_ang, ep.scan, state.node)
            obj_valid = _gather_sn(tables.obj_valid, ep.scan, state.node)
            obj_ids = _gather_sn(tables.obj_ids, ep.scan, state.node)
            obj_img = o_feat * obj_valid[:, :, None]
            o_ang_f = angle_feature(o_ang[..., 0] - base_h, o_ang[..., 1],
                                    angle_feat_size)
            o_loc = torch.cat([o_ang_f, torch.ones_like(o_ang_f[..., :3])], -1)
            loc = torch.cat([loc, o_loc], 1)
            nav = torch.cat([nav, 2 * obj_valid.to(torch.int32)], 1)
            valid = torch.cat([valid, obj_valid], 1)

    loc = loc * valid[:, :, None]
    return DuetObs(img=img, loc=loc, nav_types=nav, valid=valid,
                   cand_nodes=adj, cand_valid=adj_valid,
                   obj_ids=obj_ids, obj_valid=obj_valid, obj_img=obj_img)


def rel_pos_features(tables: WorldTables, ep: EpisodeBatch,
                     cur_node: torch.Tensor, cur_heading: torch.Tensor,
                     cur_elevation: torch.Tensor, target_nodes: torch.Tensor,
                     obs_dist: torch.Tensor, obs_hops: torch.Tensor,
                     angle_feat_size: int = 4) -> torch.Tensor:
    """DUET 7-d relative position features from the current pose to each
    target node: angle feats of (heading, elevation) + [line_dist/30,
    shortest_dist/30, path_steps/10] (graph_utils.py:127-148)."""
    xyz = tables.node_xyz[ep.scan.long()]                  # [B, N, 3]
    cur = _take(xyz, cur_node)                             # [B, 3]
    M = target_nodes.shape[1]
    tgt = torch.gather(xyz, 1, target_nodes.long()[:, :, None].expand(-1, M, 3))
    d = tgt - cur[:, None, :]
    xyz_dist = torch.clamp(torch.linalg.norm(d, dim=-1), min=1e-8)
    heading = torch.atan2(d[..., 0], d[..., 1]) - cur_heading[:, None]
    elevation = (torch.asin(torch.clamp(d[..., 2] / xyz_dist, -1, 1))
                 - cur_elevation[:, None])
    ang = angle_feature(heading, elevation, angle_feat_size)
    rel = torch.stack([xyz_dist / 30.0, obs_dist / 30.0, obs_hops / 10.0], -1)
    return torch.cat([ang, rel.to(ang.dtype)], dim=-1)


def teacher_hamt(tables: WorldTables, ep: EpisodeBatch, state: EnvState,
                 t: int, ignore_id: int,
                 shortest_teacher: bool = False) -> torch.Tensor:
    """Teacher action slot.  Time-indexed gt-path teacher by default
    (env.py:293-307): target = gt_path[t+1], stop once t reaches the end of
    the path; shortest_teacher (CVDN) follows the next hop towards the goal
    (env.py:213-219).  Returns K (the stop slot) to stop or when no
    candidate leads to the target, and ignore_id for ended items."""
    adj, adj_valid, _, _, _ = candidate_info(tables, ep, state)
    K = adj.shape[1]
    P = ep.gt_path.shape[1]
    if shortest_teacher:
        goal = ep.goal
        is_stop = state.node == goal
        target = tables.next_hop[ep.scan.long(), state.node.long(), goal.long()]
    else:
        is_stop = t >= ep.gt_len - 1
        target = ep.gt_path[:, min(max(t + 1, 0), P - 1)]
    match = adj_valid & (adj == target[:, None])
    slot = torch.argmax(match.to(torch.int32), dim=1)  # first match
    a = torch.where(is_stop | ~match.any(dim=1), K, slot)
    return torch.where(state.ended, ignore_id, a).to(torch.int32)


# Incremental DTW for per-step nDTW reward shaping (eval_utils.py:74-94).
# The DTW table over (prediction x reference) grows one row per action, so
# the rollout carries only the last row [B, P+1].

def dtw_init(tables: WorldTables, ep: EpisodeBatch) -> torch.Tensor:
    """Row for the length-1 prediction [start]."""
    B, P = ep.gt_path.shape
    row0 = torch.full((B, P + 1), INF, device=ep.gt_path.device)
    row0[:, 0] = 0.0
    return dtw_push(tables, ep, row0, ep.start_node)


def dtw_push(tables: WorldTables, ep: EpisodeBatch, row: torch.Tensor,
             new_node: torch.Tensor) -> torch.Tensor:
    """Append one prediction node: row_i -> row_{i+1}."""
    return dtw_push_multi(tables, ep, row[:, None], new_node[:, None])[:, 0]


def dtw_ndtw(row: torch.Tensor, ep: EpisodeBatch,
             threshold: float = 3.0) -> torch.Tensor:
    """nDTW of the current prediction against the (masked) reference."""
    return dtw_ndtw_multi(row[:, None], ep, threshold)[:, 0]


def dtw_push_multi(tables: WorldTables, ep: EpisodeBatch, rows: torch.Tensor,
                   new_nodes: torch.Tensor) -> torch.Tensor:
    """dtw_push over M hypothetical extensions per item: rows [B, M, P+1],
    new_nodes [B, M] -> the updated rows.  The DUET nDTW expert
    (agent.py:270-277) scores every map node's path extension with it."""
    P = ep.gt_path.shape[1]
    cost = tables.dist[ep.scan.long()[:, None, None],
                       new_nodes.long()[:, :, None],
                       ep.gt_path.long()[:, None, :]]                 # [B, M, P]
    cols = [torch.full_like(rows[..., 0], INF)]
    for j in range(1, P + 1):
        best_prev = torch.minimum(torch.minimum(rows[..., j], rows[..., j - 1]),
                                  cols[j - 1])
        cols.append(cost[..., j - 1] + best_prev)
    return torch.stack(cols, dim=-1)


def dtw_ndtw_multi(rows: torch.Tensor, ep: EpisodeBatch,
                   threshold: float = 3.0) -> torch.Tensor:
    """[B, M, P+1] rows -> [B, M] nDTW values."""
    B, M, _ = rows.shape
    dtw = rows.gather(2, ep.gt_len.long()[:, None, None].expand(B, M, 1))[..., 0]
    return torch.exp(-dtw / (threshold * ep.gt_len.float()[:, None]))
