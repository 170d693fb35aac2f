"""Batched DUET episode rollout: greedy eval, and the IL / DAgger training
half.

The port of `vln_imagine_tpu/train/rollout_duet.py`, a rebuild of
GMapNavAgent.rollout (VLN-DUET/map_nav_src/r2r/agent.py:386-625): per step
the agent encodes the panorama, folds it into the topological map (the
tensor GmapState of envx/gmap.py replaces the per-item python GraphMap),
runs the dual-scale navigation forward and *teleports* to the chosen map
node along the observed-graph shortest path.  The trajectory, multi-hop
teleports and the final stop-node backtrack (agent.py:588-601) included, is
recorded on the device in a fixed-capacity node buffer whose last column is
a trash slot.

Index conventions: model-level gmap sequences are [stop] + gmap slots, so
model index j is gmap slot j-1; local vp sequences are [stop] + pano tokens,
pano slot j-1 (candidates in pano slots [0..K)).

Semantics kept from the JAX package:
- early exit (eval only) is a check once per step whether every item has
  ended, one host sync per step; training rollouts run all T steps and
  keep ended items frozen
- the teacher: the gt path under 'teacher' feedback; otherwise the
  `expert_policy` over the unvisited map nodes: 'spl' minimises
  dist(node, goal) + dist(cur, node), 'ndtw' maximises the nDTW of the
  trajectory extended along the full-graph shortest path to the node (up
  to MAX_EXPERT_HOPS hops, agent.py:270-277); first index on ties, as
  `jnp.argmax` / `jnp.argmin`
- IL: summed CE of the fused logits with `ignoreid` skipped, then
  * train_ml / batch (agent.py:547); training stops at the gt goal, a
  sampled stop elsewhere ends the episode in place
- 'expl_sample' (agent.py:555-565): the greedy action, replaced with
  probability 1 - expl_max_ratio by a uniform draw over the valid actions;
  its stop is honoured
- `fusion="local"`: the action space is [stop] + the current node's
  candidates (agent.py:521-529), for the teacher, the expert and the move
- `act_visited_nodes` (agent.py:107-122): only the current node counts as
  visited, for the model's mask, the expert and the forced stop alike
- `train_rl`, A2C (the reference declares it and ignores it; the JAX
  package makes it work): the critic reads gmap[CLS] * vp[CLS], rewards are
  HAMT's distance + nDTW shaping on the node after the teleport (and the
  backtrack), a sampled stop is honoured, one batched critic call over T*B
  states, returns bootstrapped from 0 (every item ends by T-1)
- the teleport's hop cap: when the observed path is longer than
  MAX_TELEPORT_HOPS, the endpoint is forced into the trajectory
- the final stop table (`stop_nodes`, `stop_scores`, `stop_valid`): each
  visited map node's last stop probability, for `detailed_output`
- REVERIE / SOON objects (`obj_feat_size` > 0, tables with objects and
  episodes with `gt_obj_id`): the og_head logits of the object tokens at
  vp index 1 + K + views, the best object of each visited map node kept
  in `node_obj` (masked lanes write its trash slot), the grounding CE on
  every step whose node shows the target object, * train_ml / batch, and
  `pred_obj` read from the node the item ends on, after the stop-node
  backtrack.  A node without valid objects stores the id in its first
  object slot (the argmax over all-masked logits), as the JAX package does.
  Object features reach the model at their own width (models/duet.py);
  only with objects do the spans `env.objects`, `model.objects`,
  `model.ground` and `policy.ground` open, and the counter `objects.slots`
  (B x Ko object tokens a step through the pano encoder) count

Under data parallelism (`shard`, parallel/mesh.py) the batch is this
rank's block of the global batch, as in the HAMT rollout: the losses
divide by global denominators and the draws are the global batch's.  The
map's next-hop tables are item 0's until the first `relax` (envx/gmap.py
`_item`), and item 0 of the global batch lies on rank 0: every rank takes
rank 0's tables before that relax, so that each rank's items see what
they see in the one-process rollout.

JAX rematerialises every step of a differentiated rollout to fit a TPU's
memory; the port keeps the activations (see PERF.md for the peak).  The
incremental DTW row (the trajectory's, through every teleport and
backtrack hop) is computed only where it is read: by the nDTW expert and
the RL rewards.

One step of the loop is one function, `_step`, on a `_State` that it
rebinds field by field.  The eager loop calls it with the step's number
as an int; greedy eval on a card with spans off (`graph_engages`)
captures it, with the step's number a 0-d device tensor, as a CUDA graph
whose state lives in fixed buffers (`StepGraph`), and replays it: the
same kernels in the same order, the eager loop's results bit for bit,
without the host's issue of some 1,200 launches a step.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vln_imagine_tpu_torch.config import Config
from vln_imagine_tpu_torch.envx import env as envx
from vln_imagine_tpu_torch.envx import gmap as G
from vln_imagine_tpu_torch.envx.tables import (
    INF,
    EpisodeBatch,
    WorldTables,
    _Arrays,
)
from vln_imagine_tpu_torch.models.bert import Critic
from vln_imagine_tpu_torch.models.duet import DuetModel
from vln_imagine_tpu_torch.ops.angles import view_elevation, view_heading
from vln_imagine_tpu_torch.ops.dropout import Rng
from vln_imagine_tpu_torch.ops.masks import LOGIT_NEG_INF
from vln_imagine_tpu_torch.parallel.mesh import DataShard
from vln_imagine_tpu_torch.parallel.tensor import split_of
from vln_imagine_tpu_torch.platform import resolve_device
from vln_imagine_tpu_torch.train.rollout_hamt import (
    a2c_loss,
    imagination_input,
    sample_categorical,
    sample_uniform,
    shaped_reward,
    uniform_coin,
)
from vln_imagine_tpu_torch.utils import spans
from vln_imagine_tpu_torch.utils.spans import span

MAX_TELEPORT_HOPS = 6
MAX_BACKTRACK_HOPS = 8
MAX_EXPERT_HOPS = 8  # nDTW expert path-extension horizon


class DuetRolloutResult(NamedTuple):
    loss: torch.Tensor              # scalar IL + RL + cosine aux loss
    ml_loss: torch.Tensor
    aux_loss: torch.Tensor
    path_nodes: torch.Tensor        # [B, PB+1] (last column: trash, zeroed)
    path_len: torch.Tensor          # [B]
    logits: torch.Tensor | None     # [T, B, G+1] (None under early exit)
    actions: torch.Tensor | None    # [T, B]
    entropy_sum: torch.Tensor
    steps: int                      # steps the loop ran
    rl_loss: torch.Tensor           # scalar A2C loss (train_rl only)
    # the final stop table (--detailed_output, agent.py:597-601)
    stop_nodes: torch.Tensor        # [B, Gcap] node id per map slot
    stop_scores: torch.Tensor       # [B, Gcap] last stop probability there
    stop_valid: torch.Tensor        # [B, Gcap] slot valid and visited
    og_loss: torch.Tensor           # scalar object-grounding CE (REVERIE/SOON)
    pred_obj: torch.Tensor          # [B] i32 predicted object id (-1 none)


def path_buffer_len(cfg: Config) -> int:
    return 1 + cfg.env.max_action_len * MAX_TELEPORT_HOPS + MAX_BACKTRACK_HOPS


def _append_path(path, path_len, nodes, valid):
    """Append `nodes` (masked by `valid`) to the per-item path buffer.  The
    buffer's LAST column is a trash slot: masked lanes and overflow writes
    land there, never on a content column."""
    B, PBt = path.shape
    cap = PBt - 1
    offs = torch.cumsum(valid, dim=1) - 1
    pos = torch.where(valid, torch.clamp(path_len[:, None] + offs, max=cap), cap)
    b = torch.arange(B, device=path.device)[:, None].expand_as(pos)
    path = path.index_put((b, pos.long()),
                          torch.where(valid, nodes, path[:, -1:]))
    return path, torch.clamp(path_len + valid.sum(dim=1), max=cap).to(torch.int32)


def _edge_weights(tables, ep, src_node, dst_nodes):
    """Straight-line distances (calc_position_distance, graph_utils.py:7-13)."""
    xyz = tables.node_xyz[ep.scan.long()]
    a = envx._take(xyz, src_node)
    K = dst_nodes.shape[1]
    bpos = torch.gather(xyz, 1, dst_nodes.long()[:, :, None].expand(-1, K, 3))
    return torch.linalg.norm(bpos - a[:, None, :], dim=-1)


def _obs_dist_hops(gm, b_idx, cur_slot, t_slot):
    """Observed distance and hop count from the current slot, 0 where there
    is no observed path."""
    od = gm.dist[b_idx[:, None], cur_slot[:, None], t_slot]
    oh = gm.hops[b_idx[:, None], cur_slot[:, None], t_slot]
    od = torch.where(od >= INF / 2, 0.0, od)
    oh = torch.where(oh >= 10 ** 5, 0, oh)
    return od, oh.float()


def _vp_pos7(tables, ep, cur_node, cur_heading, cur_elev, targets, gm, b_idx,
             mcfg):
    """7-d rel-pos features of vp targets through the observed graph."""
    cur_slot = G._slot(gm, cur_node[:, None])[:, 0].long()
    t_slot = G._slot(gm, targets.clamp(min=0))
    t_slot = torch.where(t_slot >= 0, t_slot, gm.trash).long()
    od, oh = _obs_dist_hops(gm, b_idx, cur_slot, t_slot)
    return envx.rel_pos_features(tables, ep, cur_node, cur_heading, cur_elev,
                                 targets, od, oh, mcfg.angle_feat_size)


def _fix_endpoint(nodes, valid, target, do):
    """Hop-cap guard: where `do` and the capped path missed `target`, force
    the endpoint into the last hop (a gap mid-path beats a wrong endpoint,
    which decides success and SPL)."""
    reached = torch.any((nodes == target[:, None]) & valid, dim=1)
    fix = do & ~reached
    nodes, valid = nodes.clone(), valid.clone()
    nodes[:, -1] = torch.where(fix, target, nodes[:, -1])
    valid[:, -1] = valid[:, -1] | fix
    return nodes, valid


def _grow_map(tables, ep, gm, st, obs, active, shard=None):
    """Add the current node and its candidates, their edges, and relax
    through the current node (agent.py:396-398, 611-620).  Under `shard`,
    tables still without a batch dim (before the first relax) become rank
    0's: those of the global batch's item 0."""
    gm = G.add_nodes(gm, st.node[:, None], active[:, None])
    gm = G.add_nodes(gm, obs.cand_nodes, obs.cand_valid & active[:, None])
    w = _edge_weights(tables, ep, st.node, obs.cand_nodes)
    gm = G.add_edges(gm, st.node, obs.cand_nodes, w,
                     obs.cand_valid & active[:, None])
    if shard is not None and gm.nxt.shape[0] == 1:
        gm = gm.replace(nxt=shard.broadcast(gm.nxt),
                        hops=shard.broadcast(gm.hops))
    return G.relax(gm, st.node, active)


def rollout_duet(model: DuetModel, tables: WorldTables, ep: EpisodeBatch,
                 cfg: Config, rng: Rng | None = None,
                 feedback: str = "argmax", train_ml: float | None = None,
                 deterministic: bool = True, max_steps: int | None = None,
                 early_exit: bool = False, critic: Critic | None = None,
                 train_rl: bool = False,
                 shard: DataShard | None = None,
                 graphs: StepGraphs | None = None) -> DuetRolloutResult:
    """Roll out a batch of episodes; tables and ep lie on the model's device.

    feedback: 'argmax' (greedy), 'teacher' (gt-path teacher forcing),
    'sample' (actions drawn from `rng`) or 'expl_sample' (greedy, or a
    uniform draw from `rng`); the last two are supervised by
    `cfg.train.expert_policy`.  train_ml weights the IL loss; train_rl adds
    the A2C loss (needs `critic`).  `deterministic` turns every dropout off;
    `rng` is needed for dropout and for the draws.  Autograd is on only when
    a loss is asked for.  `shard`: the batch is this rank's block of a
    data-parallel global batch, and the losses are its shares.  `graphs`:
    where a call that `graph_engages` keeps its captured step
    (`make_eval_fn`'s own)."""
    if feedback not in ("argmax", "teacher", "sample", "expl_sample"):
        raise ValueError(f"feedback {feedback!r}")
    if feedback in ("teacher", "argmax"):
        train_rl = False
    training = train_ml is not None or train_rl
    if early_exit and training:
        raise ValueError("early_exit is for inference rollouts only")
    if feedback in ("sample", "expl_sample") and rng is None:
        raise ValueError(f"{feedback!r} feedback draws its actions from rng")
    if train_rl and critic is None:
        raise ValueError("train_rl needs the critic")
    drop = None if deterministic else rng
    with torch.set_grad_enabled(training):
        if graphs is not None and not graph_engages(
                ep.scan.device, training, early_exit, shard, feedback, drop,
                model):
            graphs = None
        return _rollout(model, tables, ep, cfg, rng, drop, feedback, train_ml,
                        max_steps, early_exit, critic, train_rl, shard, graphs)


def graph_engages(device: torch.device, training: bool, early_exit: bool,
                  shard: DataShard | None, feedback: str, drop,
                  model: DuetModel) -> bool:
    """Whether a rollout call replays captured graphs (`StepGraph`): greedy
    eval (argmax, early exit, no draw, no autograd) on a CUDA card by one
    process (no data-parallel `shard`, no parameter split over a model
    axis), with spans off.  Spans stay eager, since they time phases on
    the host, which a graph does not have."""
    return (device.type == "cuda" and not training and early_exit
            and shard is None and feedback == "argmax" and drop is None
            and not spans.enabled()
            and not any(split_of(p) is not None for p in model.parameters()))


class _Run(NamedTuple):
    """What every step of one rollout reads and no step changes: the
    modules, the tables, the options and the sizes; no tensor of the call."""
    model: DuetModel
    tables: WorldTables
    cfg: Config
    rng: Rng | None
    drop: Rng | None
    feedback: str
    train_ml: float | None
    train_rl: bool
    T: int                  # the step budget
    B: int
    expert: bool
    ndtw_expert: bool
    need_dtw: bool          # the trajectory's DTW row: nDTW expert, rewards
    use_obj: bool           # REVERIE / SOON objects


class _State:
    """Everything the steps of one rollout read.  The call's inputs (`ep` to
    `g_ar`) no step changes; the loop state (`st` on) each step rebinds,
    field by field, as it makes each value anew, so that the value it
    replaces is freed there.  A value read before its field is rebound is
    not read after it (`_Held` rebinds in place)."""

    __slots__ = ("ep", "txt_embeds", "imagine_embeds", "scan", "goal",
                 "b_idx", "g_ar",
                 "st", "gm", "obs", "path", "plen", "node_obj", "pred_obj",
                 "ml_acc", "og_acc", "ent_acc", "dtw_row", "last_dist",
                 "last_ndtw")

    def __init__(self):
        for name in _State.__slots__:
            object.__setattr__(self, name, None)


class _Held(_State):
    """A `_State` on a `StepGraph`'s buffers: each value assigned to a field
    is copied into that field's buffers and dropped, so that no second copy
    of a state tensor outlives the statement that made it."""

    __slots__ = ("graph",)

    def __init__(self, graph: StepGraph):
        super().__init__()
        object.__setattr__(self, "graph", graph)

    def __setattr__(self, name, value):
        object.__setattr__(self, name, self.graph.hold(name, value))


class _StepOut(NamedTuple):
    logits: torch.Tensor       # [B, A] the step's navigation logits
    action: torch.Tensor       # [B] i32
    rl: dict | None            # train_rl: the step's A2C terms


def _run_of(model, tables, ep, cfg, rng=None, drop=None, feedback="argmax",
            train_ml=None, train_rl=False, max_steps=None) -> _Run:
    tcfg = cfg.train
    expert = train_ml is not None and feedback != "teacher"
    if expert and tcfg.expert_policy not in ("spl", "ndtw"):
        raise ValueError(f"expert_policy {tcfg.expert_policy!r}")
    ndtw_expert = expert and tcfg.expert_policy == "ndtw"
    return _Run(model, tables, cfg, rng, drop, feedback, train_ml, train_rl,
                max_steps or cfg.env.max_action_len, ep.batch, expert,
                ndtw_expert, ndtw_expert or train_rl,
                cfg.model.obj_feat_size > 0 and tables.obj_feat is not None
                and ep.gt_obj_id is not None)


def _rollout(model, tables, ep, cfg, rng, drop, feedback, train_ml,
             max_steps, early_exit, critic, train_rl, shard,
             graphs) -> DuetRolloutResult:
    run = _run_of(model, tables, ep, cfg, rng, drop, feedback, train_ml,
                  train_rl, max_steps)
    if graphs is not None:
        return graphs.rollout(run, ep)
    s = _State()
    zero = torch.zeros((), device=ep.scan.device)
    aux_loss = _prologue(run, s, ep, zero, shard)
    logits_seq, actions = [], []
    ys = {k: [] for k in ("logp", "entropy", "state", "reward", "mask")}
    for t in range(run.T):
        steps = t + 1
        with span("rollout.step", step=t):
            out = _step(run, s, t)
            if train_rl:
                for k, v in out.rl.items():
                    ys[k].append(v)
            if not early_exit:
                logits_seq.append(out.logits)
                actions.append(out.action)
            elif spans.host_read(s.st.ended.all()):  # one sync a step
                break
    return _epilogue(run, s, zero, aux_loss, steps, logits_seq, actions, ys,
                     critic, shard)


# the episode fields that only the prologue's imagination reads, which the
# loop state does not keep
_IMAGINE_ONLY = ("imagine_feats", "np_weights", "imagine_images")


def _prologue(run: _Run, s: _State, ep: EpisodeBatch, zero: torch.Tensor,
              shard) -> torch.Tensor:
    """The per-episode prologue (agent.py:386-398): the call's inputs and the
    state before step 0 into `s`; returns the cosine aux loss."""
    s.ep = dataclasses.replace(ep, **dict.fromkeys(_IMAGINE_ONLY))
    with span("rollout.prologue"):
        _start(run, s, shard)
        return _imagine(run, s, ep, zero, shard)


def _start(run: _Run, s: _State, shard) -> None:
    """The prologue but for the imagination: the text, the first
    observation and the map, from the episodes in `s.ep`."""
    model, tables, cfg, ep = run.model, run.tables, run.cfg, s.ep
    mcfg, ecfg = cfg.model, cfg.env
    B, Gcap = run.B, ecfg.max_gmap_nodes
    dev = ep.scan.device
    s.b_idx = torch.arange(B, device=dev)
    s.g_ar = torch.arange(Gcap, device=dev)
    s.scan = ep.scan.long()
    s.node_obj = torch.full((B, Gcap + 1), -1, dtype=torch.int32, device=dev)
    s.pred_obj = torch.full((B,), -1, dtype=torch.int32, device=dev)
    s.ml_acc = s.og_acc = s.ent_acc = torch.zeros((), device=dev)
    with span("model.text"):
        s.txt_embeds = model.text(ep.txt_ids, ep.txt_mask, run.drop)
    with span("env.reset"):
        s.st = envx.reset(tables, ep, run.T)
        s.obs = envx.observe_duet(tables, ep, s.st, mcfg.angle_feat_size)
        path = torch.zeros((B, path_buffer_len(cfg) + 1), dtype=torch.int32,
                           device=dev)
        path[:, 0] = ep.start_node
        s.path = path
        s.plen = torch.ones((B,), dtype=torch.int32, device=dev)
        if run.need_dtw:
            s.dtw_row = envx.dtw_init(tables, ep)
        if run.train_rl:
            s.last_dist = envx.distance_to_goal(tables, ep, s.st.node)
            s.last_ndtw = envx.dtw_ndtw(s.dtw_row, ep, ecfg.error_margin)
    with span("map.grow"):
        gm = G.gmap_init(B, Gcap, tables.max_nodes, mcfg.hidden_size, dev)
        s.gm = _grow_map(tables, ep, gm, s.st, s.obs,
                         torch.ones((B,), dtype=torch.bool, device=dev), shard)
    s.goal = ep.goal  # the gt path's last node


def _imagine(run: _Run, s: _State, ep: EpisodeBatch, zero: torch.Tensor,
             shard) -> torch.Tensor:
    """The prologue's imagination (into `s.imagine_embeds`) and the cosine
    aux loss, which it returns; reads `ep` whole."""
    model, mcfg, drop = run.model, run.cfg.model, run.drop
    aux_loss = zero
    if mcfg.imagine_enc_pano:
        with span("model.imagine"):
            s.imagine_embeds = model.imagine(imagination_input(ep, mcfg), drop)
        if mcfg.use_cosine_aux_loss:
            with span("model.align"):
                aux_loss, s.imagine_embeds = model.align_with_contrastive_loss(
                    s.txt_embeds, ep.txt_mask, s.imagine_embeds,
                    ep.imagine_mask, ep.np_weights, drop, shard=shard)
    return aux_loss


def _dtw_extend(tables, ep, row, hop_nodes, hop_valid):
    """Fold the appended path nodes into the DTW row, hop by hop."""
    for i in range(hop_nodes.shape[1]):
        new = envx.dtw_push(tables, ep, row, hop_nodes[:, i])
        row = torch.where(hop_valid[:, i, None], new, row)
    return row


def _step(run: _Run, s: _State, t) -> _StepOut:
    """One step of the rollout loop (agent.py:400-620), on `s` in place.
    `t` is the step's number: an int, or a 0-d int32 tensor on the device
    (a captured step, which greedy eval alone takes: the teacher reads `t`
    on the host)."""
    model, tables, cfg = run.model, run.tables, run.cfg
    mcfg, tcfg, ecfg = cfg.model, cfg.train, cfg.env
    feedback, train_ml = run.feedback, run.train_ml
    rng, drop = run.rng, run.drop
    B, T = run.B, run.T
    K = tables.max_candidates
    Gcap = ecfg.max_gmap_nodes
    ignore = tcfg.ignoreid
    local = mcfg.fusion == "local"
    ep, scan, goal, b_idx, g_ar = s.ep, s.scan, s.goal, s.b_idx, s.g_ar
    spans.count("rollout.steps")

    with span("map.visit"):
        active = ~s.st.ended
        s.gm = G.set_visited(s.gm, s.st.node, t, active)

    with span("model.panorama"):
        obs = s.obs
        if obs.obj_img is not None:  # object tokens encoded
            spans.count("objects.slots", obs.obj_img.shape[0]
                        * obs.obj_img.shape[1])
        pano = model.panorama_per_step(obs.img, obs.loc, obs.nav_types,
                                       obs.valid, drop, obs.obj_img)
        denom = torch.clamp(obs.valid.sum(dim=1, keepdim=True), min=1)
        avg_pano = torch.sum(pano * obs.valid[:, :, None], dim=1) / denom
    with span("map.update"):
        s.gm = G.update_embeds(s.gm, s.st.node, avg_pano, obs.cand_nodes,
                               pano[:, :K], obs.cand_valid, active)

    # ---------------- model inputs ([stop] + gmap slots)
    with span("map.inputs"):
        gm, st = s.gm, s.st
        gvalid_s = gm.valid()[:, :Gcap]
        gnodes = gm.node_ids[:, :Gcap]
        cur_slot = G._slot(gm, st.node[:, None])[:, 0].long()
        if tcfg.act_visited_nodes:
            # only the CURRENT node counts as visited (agent.py:107-122);
            # the reference feeds this same mask to the expert and to the
            # forced stop (no_vp_left) below, not the true visited set
            act_visited_s = (g_ar[None, :] == cur_slot[:, None]) & gvalid_s
        else:
            act_visited_s = gm.visited[:, :Gcap] & gvalid_s
        ones_b = torch.ones((B, 1), dtype=torch.bool, device=b_idx.device)
        gmap_img = F.pad(G.node_embeds(gm)[:, :Gcap].to(pano.dtype),
                         (0, 0, 1, 0))
        gmap_step_ids = F.pad(gm.step_ids[:, :Gcap], (1, 0))
        gmap_valid = torch.cat([ones_b, gvalid_s], dim=1)
        gmap_visited = F.pad(act_visited_s, (1, 0))

        cur_heading = view_heading(st.view_index, tables.views)
        cur_elev = view_elevation(st.view_index, tables.views)
        obs_dist, obs_hops = _obs_dist_hops(
            gm, b_idx, cur_slot, g_ar[None, :].expand(B, Gcap))
        gpos = envx.rel_pos_features(tables, ep, st.node, cur_heading,
                                     cur_elev, gnodes, obs_dist, obs_hops,
                                     mcfg.angle_feat_size)
        gmap_pos = F.pad(gpos * gvalid_s[:, :, None], (0, 0, 1, 0))
        gmap_pair = F.pad(G.pair_dists(gm)[:, :Gcap, :Gcap], (1, 0, 1, 0))

        # local vp branch: [stop] + pano tokens (agent.py:173-207)
        Tp = pano.shape[1]
        vp_img = F.pad(pano, (0, 0, 1, 0))
        start7 = _vp_pos7(tables, ep, st.node, cur_heading, cur_elev,
                          ep.start_node[:, None], gm, b_idx, mcfg)[:, 0]
        cand7 = _vp_pos7(tables, ep, st.node, cur_heading, cur_elev,
                         obs.cand_nodes, gm, b_idx, mcfg)
        cand7 = F.pad(cand7 * obs.cand_valid[:, :, None], (0, 0, 1, Tp - K))
        vp_pos = torch.cat([start7[:, None, :].expand(B, Tp + 1, 7), cand7],
                           dim=-1)
        vp_valid = torch.cat([ones_b, obs.valid], dim=1)
        vp_nav_valid = torch.cat([ones_b, obs.nav_types == 1], dim=1)

        # candidate (vp token j>0) <-> gmap slot matching
        cand_slot = G._slot(gm, obs.cand_nodes.clamp(min=0))  # [B, K]
        c2g = ((g_ar[None, :, None] == cand_slot[:, None, :])
               & obs.cand_valid[:, None, :]
               & (cand_slot >= 0)[:, None, :])
        cand_to_gmap = F.pad(c2g, (1, Tp - K, 1, 0))
        vp_obj_valid = (F.pad(obs.nav_types == 2, (1, 0)) if run.use_obj
                        else None)

    with span("model.navigation"):
        out = model.navigation_per_step(
            s.txt_embeds, ep.txt_mask, gmap_img, gmap_step_ids, gmap_pos,
            gmap_valid, gmap_pair, gmap_visited, vp_img, vp_pos, vp_valid,
            vp_nav_valid, cand_to_gmap, imagine_embeds=s.imagine_embeds,
            imagine_mask=ep.imagine_mask, vp_obj_valid=vp_obj_valid, rng=drop)
        nav_logits = (out.local_logits if local
                      else out.global_logits if mcfg.fusion == "global"
                      else out.fused_logits)

    with span("policy.select"):
        # the stop score at the current node (agent.py:515-520)
        probs = torch.softmax(nav_logits.detach().float(), dim=-1)
        stop_tgt = torch.where(active, cur_slot, gm.trash)
        s.gm = gm.replace(stop_scores=gm.stop_scores.index_put(
            (b_idx, stop_tgt),
            torch.where(stop_tgt == gm.trash, gm.stop_scores[:, -1],
                        probs[:, 0])))

        # ------------ teacher (agent.py:241-287, _teacher_action_r4r): map
        # slots j-1, or under fusion 'local' candidate tokens j-1
        no_vp_left = ~torch.any(gvalid_s & ~act_visited_s, dim=1)
        teacher = None  # greedy eval and RL rollouts read no teacher
        if feedback == "teacher":
            tgt_node = ep.gt_path[:, min(t + 1, ep.gt_path.shape[1] - 1)]
            nodes, ok = ((obs.cand_nodes, obs.cand_valid) if local
                         else (gnodes, gvalid_s))
            match = (nodes == tgt_node[:, None]) & ok
            slot = torch.argmax(match.to(torch.int32), dim=1) + 1
            # a missing target means the map buffer overflowed: ignore it
            teacher = torch.where(
                t >= ep.gt_len - 1, 0,
                torch.where(match.any(dim=1), slot, ignore))
        elif run.expert:
            nodes, ok = ((obs.cand_nodes, obs.cand_valid) if local
                         else (gnodes, gvalid_s & ~act_visited_s))
            if run.ndtw_expert:
                rows = s.dtw_row[:, None, :].expand(B, nodes.shape[1], -1)
                if local:  # one step to each candidate
                    rows = envx.dtw_push_multi(tables, ep, rows, nodes)
                else:  # along the full-graph shortest path to each
                    rows = _expert_rows(tables, ep, rows, st.node, nodes)
                cost = -envx.dtw_ndtw_multi(rows, ep, ecfg.error_margin)
            else:  # 'spl'
                cost = (tables.dist[scan[:, None], nodes.long(),
                                    goal.long()[:, None]]
                        + tables.dist[scan[:, None], st.node.long()[:, None],
                                      nodes.long()])
            cost = torch.where(ok, cost, INF)
            slot = torch.argmin(cost, dim=1) + 1
            teacher = torch.where(
                st.node == goal, 0,
                torch.where(ok.any(dim=1), slot, ignore))
        if teacher is not None:
            teacher = torch.where(st.ended, ignore, teacher).to(torch.int32)

        if train_ml is not None:
            logp = torch.log_softmax(nav_logits.float(), dim=-1)
            tgt = teacher.clamp(0, logp.shape[1] - 1).long()
            ce = -logp.gather(1, tgt[:, None])[:, 0]
            s.ml_acc = s.ml_acc + torch.sum(torch.where(teacher == ignore,
                                                        0.0, ce))

        # ------------ action selection (agent.py:545-575)
        valid_act = (vp_nav_valid if local
                     else gmap_valid & ~gmap_visited).clone()
        valid_act[:, 0] = True
        logp_a = ent = None
        if feedback == "teacher":
            a_t = teacher
        else:
            logp = torch.log_softmax(torch.where(
                valid_act, nav_logits, LOGIT_NEG_INF).float(), dim=-1)
            ent = -torch.sum(torch.where(valid_act, logp.exp() * logp, 0.0),
                             dim=-1)
            s.ent_acc = s.ent_acc + torch.sum(torch.where(st.ended, 0.0,
                                                          ent))
            if feedback == "argmax":
                a_t = torch.argmax(logp, dim=-1)
            elif feedback == "sample":
                a_t = sample_categorical(logp, rng)
            else:  # 'expl_sample'
                explore = uniform_coin(B, rng) > tcfg.expl_max_ratio
                a_t = torch.where(explore, sample_uniform(valid_act, rng),
                                  torch.argmax(logp, dim=-1))
            a_t = a_t.to(torch.int32)
            logp_a = logp.gather(1, a_t.long()[:, None])[:, 0]

        # stop rule (agent.py:570-575): training stops at the gt goal,
        # inference (and A2C, 'expl_sample') on the predicted stop.  A
        # sampled stop away from the goal ends the episode in place, with
        # no stop-score backtrack (agent.py:584,610)
        if run.train_rl or feedback not in ("teacher", "sample"):
            a_t_stop = a_t == 0
            end_in_place = torch.zeros_like(a_t_stop)
        else:
            a_t_stop = st.node == goal
            end_in_place = ((a_t == 0) & ~a_t_stop if feedback == "sample"
                            else torch.zeros_like(a_t_stop))
        stop_now = (a_t_stop | st.ended | no_vp_left | (a_t == ignore)
                    | end_in_place)
        last = t == T - 1  # the last step stops every item
        if torch.is_tensor(last):
            stop_now = stop_now | last
        elif last:
            stop_now = torch.ones_like(stop_now)
        just_ended = stop_now & ~st.ended

        if local:  # a_t - 1 indexes the current candidates
            move_tgt = envx._take(obs.cand_nodes,
                                  torch.clamp(a_t - 1, 0, K - 1))
        else:
            move_tgt = envx._take(gnodes, torch.clamp(a_t - 1, 0, Gcap - 1))
        tgt_node = torch.where(stop_now, st.node, move_tgt)

    with span("map.path"):
        # ------------ teleport along the observed path (agent.py:289-305)
        gm = s.gm
        hop_nodes, hop_valid = G.follow_path(gm, st.node, tgt_node,
                                             MAX_TELEPORT_HOPS)
        moving = ~stop_now & ~st.ended
        hop_nodes, hop_valid = _fix_endpoint(
            hop_nodes, hop_valid & moving[:, None], tgt_node, moving)
        path, plen = _append_path(s.path, s.plen, hop_nodes, hop_valid)
        if run.need_dtw:
            s.dtw_row = _dtw_extend(tables, ep, s.dtw_row, hop_nodes,
                                    hop_valid)

        n_hops = hop_valid.sum(dim=1)
        prev_node = torch.where(
            n_hops >= 2, envx._take(hop_nodes, torch.clamp(n_hops - 2, min=0)),
            st.node)
        new_node = torch.where(moving, tgt_node, st.node)
        # adopt the discretized view of the final approach edge
        adj_prev = tables.adj[scan, prev_node.long()]
        pid_prev = tables.cand_pointid[scan, prev_node.long()]
        k_match = torch.argmax((adj_prev == new_node[:, None]).to(torch.int32),
                               dim=1)
        new_view = torch.where(moving, envx._take(pid_prev, k_match),
                               st.view_index)

        # ------------ stop-node backtrack for just-ended items
        # (agent.py:588-601): jump to the visited node of highest stop score
        scored = torch.where(gm.valid() & gm.visited, gm.stop_scores,
                             -torch.inf)
        best_stop_slot = torch.argmax(scored, dim=1)
        best_stop_node = envx._take(gm.node_ids, best_stop_slot)
        has_score = torch.any(torch.isfinite(scored), dim=1)
        do_back = (just_ended & ~end_in_place & has_score
                   & (best_stop_node != st.node))
        back_nodes, back_valid = G.follow_path(gm, st.node, best_stop_node,
                                               MAX_BACKTRACK_HOPS)
        back_nodes, back_valid = _fix_endpoint(
            back_nodes, back_valid & do_back[:, None], best_stop_node, do_back)
        s.path, s.plen = _append_path(path, plen, back_nodes, back_valid)
        if run.need_dtw:
            s.dtw_row = _dtw_extend(tables, ep, s.dtw_row, back_nodes,
                                    back_valid)

    if run.use_obj:
        with span("policy.ground"):
            # object grounding (reverie agent `_teacher_object` + og logits):
            # the best object of the current node, and the CE against the
            # target object where it is visible
            Ko = tables.max_objects
            obj_tok0 = 1 + K + tables.views  # first object token
            obj_lg = out.obj_logits[:, obj_tok0:obj_tok0 + Ko]
            best_id = envx._take(obs.obj_ids, torch.argmax(obj_lg, dim=1))
            store = torch.where(active, cur_slot, gm.trash)
            s.node_obj = s.node_obj.index_put(
                (b_idx, store), torch.where(store == gm.trash,
                                            s.node_obj[:, -1], best_id))
            if train_ml is not None:
                gt_match = ((obs.obj_ids == ep.gt_obj_id[:, None])
                            & obs.obj_valid)
                og_logp = torch.log_softmax(torch.where(
                    obs.obj_valid, obj_lg, LOGIT_NEG_INF).float(), dim=-1)
                gt_k = torch.argmax(gt_match.to(torch.int32), dim=1)
                og_ce = -og_logp.gather(1, gt_k[:, None])[:, 0]
                s.og_acc = s.og_acc + torch.sum(
                    torch.where(active & gt_match.any(1), og_ce, 0.0))
            # the object of the node the item ends on: the backtrack's
            # target, else the current node
            final_slot = torch.where(has_score & just_ended & ~end_in_place,
                                     best_stop_slot, cur_slot)
            chosen = envx._take(s.node_obj, final_slot.clamp(0, gm.trash))
            s.pred_obj = torch.where(just_ended, chosen, s.pred_obj)

    rl = None
    if run.train_rl:
        with span("env.reward"):
            # reward shaping on the node after the teleport, or after the
            # backtrack for just-ended items (agent_cmt.py:615-653)
            ended_pre = st.ended
            eff_node = torch.where(do_back, best_stop_node, new_node)
            dist = tables.dist[scan, eff_node.long(), goal.long()]
            ndtw = envx.dtw_ndtw(s.dtw_row, ep, ecfg.error_margin)
            reward = shaped_reward(dist, ndtw, s.last_dist, s.last_ndtw,
                                   just_ended, ended_pre)
            s.last_dist = torch.where(ended_pre, s.last_dist, dist)
            s.last_ndtw = torch.where(ended_pre, s.last_ndtw, ndtw)
            rl = {"reward": reward, "mask": torch.where(ended_pre, 0.0, 1.0),
                  "logp": logp_a, "entropy": ent,
                  "state": out.gmap_embeds[:, 0] * out.vp_embeds[:, 0]}

    with span("env.step"):
        s.st = st.replace(node=new_node, view_index=new_view,
                          ended=st.ended | stop_now, step=st.step + 1)

    # ------------ observe the new node, grow the graph
    with span("env.observe"):
        s.obs = envx.observe_duet(tables, ep, s.st, mcfg.angle_feat_size)
    with span("map.grow"):
        s.gm = _grow_map(tables, ep, s.gm, s.st, s.obs, ~s.st.ended)
    return _StepOut(nav_logits, a_t, rl)


def _epilogue(run: _Run, s: _State, zero, aux_loss, steps, logits_seq,
              actions, ys, critic, shard) -> DuetRolloutResult:
    mcfg, tcfg = run.cfg.model, run.cfg.train
    B, Gcap, gm = run.B, run.cfg.env.max_gmap_nodes, s.gm
    with span("rollout.epilogue"):
        path = s.path.clone()
        path[:, -1] = 0  # the trash column: a deterministic output
        ml_loss = rl_loss = og_loss = zero
        loss = mcfg.cosine_weight * aux_loss if mcfg.use_cosine_aux_loss else zero
        n_items = B if shard is None else B * shard.size  # the global batch's
        if run.train_ml is not None:
            ml_loss = s.ml_acc * run.train_ml / n_items
            loss = loss + ml_loss
            if run.use_obj:
                og_loss = s.og_acc * run.train_ml / n_items
                loss = loss + og_loss
        if run.train_rl:
            # every item ends by T-1, so the return after the last step is 0
            states = torch.stack(ys["state"]).float()              # [T, B, H]
            values = critic(states, run.drop, batch_dim=1).float()  # [T, B]
            # the entropy bonus only under 'sample' (not 'expl_sample')
            rl_loss = a2c_loss(
                values, torch.stack(ys["reward"]), torch.stack(ys["mask"]),
                torch.stack(ys["logp"]),
                torch.stack(ys["entropy"]) if run.feedback == "sample"
                else None,
                torch.zeros((B,), device=zero.device), tcfg, n_items, shard)
            loss = loss + rl_loss
    return DuetRolloutResult(
        loss=loss, ml_loss=ml_loss, aux_loss=aux_loss, path_nodes=path,
        path_len=s.plen,
        logits=torch.stack(logits_seq) if logits_seq else None,
        actions=torch.stack(actions) if actions else None,
        entropy_sum=s.ent_acc, steps=steps, rl_loss=rl_loss,
        stop_nodes=gm.node_ids[:, :Gcap], stop_scores=gm.stop_scores[:, :Gcap],
        stop_valid=(gm.valid() & gm.visited)[:, :Gcap], og_loss=og_loss,
        pred_obj=s.pred_obj)


def _expert_rows(tables, ep, rows, cur_node, nodes):
    """The DTW rows [B, M, P+1] extended hop by hop along the full-graph
    shortest path from `cur_node` to each of `nodes` [B, M], for up to
    MAX_EXPERT_HOPS hops (the nDTW expert, agent.py:270-277)."""
    scan = ep.scan.long()[:, None]
    cur = cur_node[:, None].expand_as(nodes)
    done = torch.zeros(nodes.shape, dtype=torch.bool, device=nodes.device)
    for _ in range(MAX_EXPERT_HOPS):
        stepping = ~done & (cur != nodes)
        nxt = torch.where(stepping,
                          tables.next_hop[scan, cur.long(), nodes.long()], cur)
        new = envx.dtw_push_multi(tables, ep, rows, nxt)
        rows = torch.where(stepping[..., None], new, rows)
        done = done | (nxt == nodes)
        cur = nxt
    return rows



class StepGraph:
    """Two CUDA graphs for the greedy-eval calls of one shape, in one memory
    pool: the prologue's start (`_start`: the text, the first observation
    and the map) and one step of the loop; and the buffers they read and
    write: each field of `_State` (`hold`), the step's number `t` and the
    flag `done` (every item has ended).

    A call copies its episodes into their buffers, replays the start, runs
    the imagination eagerly (it reads the call's own imagination features,
    which no buffer keeps), then the steps, each one replay and one host
    read of `done`, and the epilogue eagerly.  The start's capture makes
    the state's buffers in the pool after the text encoder's temporaries
    are freed, so that the two share memory as in an eager call; the step's
    capture takes its temporaries from the same pool.

    The first call of a shape runs each part once eagerly before capturing
    it, so that the libraries' handles and every kernel are loaded; it runs
    step 0 that way.  Each replay adds on the host the counts that its
    capture made (`rollout.steps`, `objects.slots`, the kernels'
    `launches.*`); a step's replay counts `rollout.graph_replays`, a
    capture `rollout.graph_captures`.  A capture that fails raises."""

    def __init__(self):
        self.bufs: dict[str, torch.Tensor] = {}
        self.start: torch.cuda.CUDAGraph | None = None
        self.first: dict = {}  # `_State`'s fields after the start
        self.start_counts = None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.counts = None  # what one step counts

    def hold(self, name: str, value):
        """`value` on this graph's buffers: a tensor copied into the buffer
        `name` (at the name's first hold, its own copy), a dataclass of
        arrays or a NamedTuple field by field (`name.field`), anything else
        as it is."""
        if torch.is_tensor(value):
            buf = self.bufs.get(name)
            if buf is None:
                buf = self.bufs[name] = value.clone()
            elif buf is not value:
                buf.copy_(value)
            return buf
        if isinstance(value, _Arrays):
            return value.replace(**{
                f.name: self.hold(f"{name}.{f.name}", getattr(value, f.name))
                for f in dataclasses.fields(value)})
        if isinstance(value, tuple) and hasattr(value, "_fields"):
            return value._replace(**{
                k: self.hold(f"{name}.{k}", v)
                for k, v in zip(value._fields, value)})
        return value

    def begin(self, run: _Run, ep: EpisodeBatch) -> _Held:
        """The state after the start of a call on `ep`, on the buffers."""
        s = _Held(self)
        s.ep = dataclasses.replace(ep, **dict.fromkeys(_IMAGINE_ONLY))
        if self.start is None:
            warm = _State()
            warm.ep = s.ep
            _start(run, warm, None)
            del warm
            graph = torch.cuda.CUDAGraph()
            with spans.held_counts() as counts, torch.cuda.graph(
                    graph, stream=torch.cuda.current_stream(ep.scan.device)):
                _start(run, s, None)
            self.start, self.start_counts = graph, counts
            self.first = {k: getattr(s, k) for k in _State.__slots__}
            spans.count("rollout.graph_captures")
        self.start.replay()
        spans.add_counts(self.start_counts)
        for k, v in self.first.items():
            object.__setattr__(s, k, v)
        return s

    def advance(self, run: _Run, s: _Held, t: torch.Tensor,
                done: torch.Tensor) -> None:
        """One step on the buffers: what the graph captures."""
        _step(run, s, t)
        torch.all(s.st.ended, out=done)
        t.add_(1)

    def run(self, run: _Run, s: _Held) -> int:
        """The step loop of one call, on the state the prologue left in `s`;
        returns the number of steps run."""
        dev = s.b_idx.device
        t = self.hold("t", torch.zeros((), dtype=torch.int32, device=dev))
        done = self.hold("done", torch.zeros((), dtype=torch.bool,
                                             device=dev))
        steps = 0
        if self.graph is None:
            self.advance(run, s, t, done)
            steps = 1
            if spans.host_read(done):
                return steps
            graph = torch.cuda.CUDAGraph()
            with spans.held_counts() as counts, torch.cuda.graph(
                    graph, pool=self.start.pool(),
                    stream=torch.cuda.current_stream(dev)):
                self.advance(run, s, t, done)
            self.graph, self.counts = graph, counts
            spans.count("rollout.graph_captures")
        while steps < run.T:
            self.graph.replay()
            steps += 1
            spans.add_counts(self.counts)
            spans.count("rollout.graph_replays")
            if spans.host_read(done):  # one sync a step
                break
        return steps


# one stream a device for the calls with graphs: a capture is refused on the
# legacy default stream, and each stream that cuBLAS works on keeps a
# workspace of its own (32 MiB on the H100)
_eval_streams: dict[torch.device, torch.cuda.Stream] = {}


def _eval_stream(device: torch.device) -> torch.cuda.Stream:
    stream = _eval_streams.get(device)
    if stream is None:
        stream = _eval_streams[device] = torch.cuda.Stream(device)
    return stream


class StepGraphs:
    """The captured steps of one model and one set of tables (`make_eval_fn`
    keeps one), a `StepGraph` for each shape of call: the batch, the step
    budget, whether objects are read, and each episode field's shape and
    dtype.  A graph reads the parameters' compute-dtype copies that the
    modules cache (`models/bert.py:_cast_cached`), which an in-place update
    (`load_state_dict`, an optimizer step) makes stale: so all are dropped,
    to be captured again, once a parameter or buffer of the model lies at
    another address or has been written since.

    Every call runs on the device's eval stream (`_eval_stream`), waited
    for at entry and exit."""

    def __init__(self, model: DuetModel):
        self.model = model
        self.graphs: dict[tuple, StepGraph] = {}
        self.params: list[tuple[int, int]] = []

    def graph(self, run: _Run, ep: EpisodeBatch) -> StepGraph:
        params = [(x.data_ptr(), x._version) for x in itertools.chain(
            self.model.parameters(), self.model.buffers())]
        if params != self.params:
            self.graphs.clear()
            self.params = params
        key = (run.B, run.T, run.use_obj) + tuple(
            (f.name, None if x is None else (tuple(x.shape), x.dtype))
            for f in dataclasses.fields(ep) for x in [getattr(ep, f.name)])
        if key not in self.graphs:
            self.graphs[key] = StepGraph()
        return self.graphs[key]

    def rollout(self, run: _Run, ep: EpisodeBatch) -> DuetRolloutResult:
        """One greedy-eval call on the graphs of its shape (`StepGraph`);
        the result owns its tensors."""
        graph = self.graph(run, ep)
        dev = ep.scan.device
        main, stream = torch.cuda.current_stream(dev), _eval_stream(dev)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            s = graph.begin(run, ep)
            zero = torch.zeros((), device=dev)
            aux_loss = _imagine(run, s, ep, zero, None)
            steps = graph.run(run, s)
            res = _epilogue(run, s, zero, aux_loss, steps, [], [], {}, None,
                            None)
            res = res._replace(**{k: getattr(res, k).clone() for k in (
                "path_len", "entropy_sum", "stop_nodes", "stop_scores",
                "pred_obj")})
        main.wait_stream(stream)
        for x in res:
            if torch.is_tensor(x):
                x.record_stream(main)
        return res


def make_eval_fn(model: DuetModel, tables: WorldTables, cfg: Config,
                 device=None, detailed: bool = False,
                 shard: DataShard | None = None):
    """Greedy-eval rollout on `device` (the card unless the caller names
    one): episodes -> (path_nodes, path_len); with objects then the
    grounded object id per item (REVERIE / SOON, for RGS), and with
    `detailed` last the final stop table (stop_nodes, stop_scores,
    stop_valid).  Moves the model and the tables there once.
    `eval_fn.steps` is the number of steps the last call's loop ran.
    On a card with spans off and no `shard`, the steps are replays of a
    captured CUDA graph (`StepGraphs`), the eager loop's results bit for
    bit.  Under `shard` each rank evaluates its block of a global batch,
    and every rank calls it equally often (the map's first tables come
    from rank 0)."""
    dev = resolve_device(device)
    model.to(dev).eval()
    tables = tables.to(dev)
    use_obj = cfg.model.obj_feat_size > 0 and tables.obj_feat is not None
    graphs = StepGraphs(model)

    def eval_fn(ep: EpisodeBatch):
        with span("eval.call"):
            res = rollout_duet(model, tables, ep.to(dev), cfg, early_exit=True,
                               shard=shard, graphs=graphs)
        eval_fn.steps = res.steps
        out = (res.path_nodes, res.path_len)
        if use_obj:
            out = out + (res.pred_obj,)
        if detailed:
            out = out + ((res.stop_nodes, res.stop_scores, res.stop_valid),)
        return out

    return eval_fn
