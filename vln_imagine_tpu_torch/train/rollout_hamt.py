"""Batched HAMT episode rollout: greedy eval, and the IL / RL training half.

The port of `vln_imagine_tpu/train/rollout_hamt.py`.  The reference's
rollout (VLN-HAMT/finetune_src/r2r/agent_cmt.py:371-759) alternates host
feature packing, per-item simulator calls and CUDA forwards; here every step
is tensor code on one device: observation, visual forward, action
selection, history update, env transition and reward shaping.

Semantics kept from the JAX package:
- items that pick STOP still append one history token but freeze afterwards
  (agent_cmt.py:586-609)
- the history buffer has T+1 fixed slots written under a mask, so the step
  body keeps static shapes
- early exit (eval only) is the reference's python `break`
  (agent_cmt.py:658-659): the loop checks once per step whether every item
  has ended, which costs one host sync per step.  Training rollouts run all
  T steps and keep ended items frozen
- teacher CE: sum reduction over steps and items on the unmasked logits,
  `ignoreid` skipped, then * train_ml / batch (agent_cmt.py:105,547,747)
- RL reward shaping: +-2 terminal with an nDTW bonus, +-1 move shaping with
  delta-nDTW, near-miss penalty (:615-653), on the incremental DTW row
- A2C: discounted returns seeded with the critic value of the final state
  (under stop-gradient) for unfinished items, one batched critic call over
  all T*B step states (not detached: the critic loss reaches the model),
  0.5 L2 critic loss, entropy bonus under 'sample' and 'mixed', normalised
  by `normalize_loss` (:661-744)
- 'mixed' feedback is the fused rollout of one train step: a batch of 2B
  items where those in `il_mask` take the teacher action and the rest
  sample.  CE covers only the IL items and entropy and A2C only the others,
  each normalised by its own half's size; the alignment loss is the sum of
  each half's own mean, with negatives from the same half
  (`contrastive_alignment_loss(groups=...)`).  Each half's losses are
  those of the two separate rollouts it replaces.
- r2r_back (Seq2SeqBackAgent, agent_r2rback.py:100-276): the first stop
  records the midstop and the episode goes on; the second stop ends it.
  Rewards target the midstop until the first stop and the goal after it;
  under RL, a first stop 3 m or more from the midstop ends the item
- CVDN (cfg.dataset 'cvdn'): the teacher follows the shortest path to the
  goal (cvdn/env.py:213-219) instead of the annotated path
- REVERIE objects (NavRefCMTAgent, reverie/agent.py:141-165, 271-304): the
  grounding CE is supervised on the step the teacher stops (at the goal
  viewpoint) and added as og_loss / batch, unweighted by train_ml
  (:449); the predicted object is recorded on the step an item stops,
  the forced stop at T-1 included
- data parallelism (`shard`, parallel/mesh.py): the batch is this rank's
  block of the global batch; every loss divides by its global denominator
  (a rank's losses are its shares of the global ones) and every draw is
  the global batch's (ops/dropout.py), so the shares' gradients sum to the
  global step's
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vln_imagine_tpu_torch.config import Config
from vln_imagine_tpu_torch.envx import env as envx
from vln_imagine_tpu_torch.envx.tables import EpisodeBatch, WorldTables
from vln_imagine_tpu_torch.models.bert import Critic
from vln_imagine_tpu_torch.models.hamt import HamtModel
from vln_imagine_tpu_torch.ops.dropout import Rng
from vln_imagine_tpu_torch.ops.masks import LOGIT_NEG_INF
from vln_imagine_tpu_torch.parallel.mesh import DataShard, global_sum
from vln_imagine_tpu_torch.platform import resolve_device
from vln_imagine_tpu_torch.utils import spans
from vln_imagine_tpu_torch.utils.spans import span


class RolloutResult(NamedTuple):
    loss: torch.Tensor              # scalar total loss (IL + RL + aux)
    ml_loss: torch.Tensor           # scalar
    rl_loss: torch.Tensor           # scalar
    aux_loss: torch.Tensor          # scalar alignment loss
    path_nodes: torch.Tensor        # [B, T+1]
    path_len: torch.Tensor          # [B]
    logits: torch.Tensor | None     # [T, B, T_obs] (None under early exit)
    actions: torch.Tensor | None    # [T, B]
    entropy_sum: torch.Tensor       # scalar, 'sample' / 'mixed' (log metric)
    steps: int                      # steps the loop ran
    midstop: torch.Tensor           # [B] i32 declared midstop (r2r_back; -1 none)
    og_loss: torch.Tensor           # scalar REVERIE grounding CE
    pred_obj: torch.Tensor          # [B] i32 predicted object id at stop (-1)


def sample_categorical(logp: torch.Tensor, rng: Rng) -> torch.Tensor:
    """One draw per row from the categorical distribution of `logp` [B, K],
    by the Gumbel-max trick as `jax.random.categorical` (no host sync)."""
    u = rng.rand(logp.shape, logp.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logp + gumbel, dim=-1)


def uniform_coin(batch: int, rng: Rng) -> torch.Tensor:
    """[batch] draws from U[0, 1), as `jax.random.uniform`."""
    return rng.rand((batch,))


def sample_uniform(valid: torch.Tensor, rng: Rng) -> torch.Tensor:
    """One draw per row, uniform over the row's valid entries of [B, K]
    (a categorical over a uniform logit, as the JAX package draws it)."""
    return sample_categorical(torch.where(valid, 0.0, LOGIT_NEG_INF), rng)


def shaped_reward(dist, ndtw, last_dist, last_ndtw, stopped, ended_pre):
    """One step's RL reward per item (agent_cmt.py:615-653): at a stop +2
    plus twice the nDTW within 3 m of the goal, else -2; on a move +-1 by
    the sign of the distance gained, plus the nDTW gained, less a penalty
    for leaving the goal's 1 m ring; 0 for items that had already ended."""
    stop_rew = torch.where(dist < 3.0, 2.0 + ndtw * 2.0, -2.0)
    delta = -(dist - last_dist)
    ndtw_rew = ndtw - last_ndtw
    move_rew = torch.where(delta > 0.0, 1.0 + ndtw_rew,
                           torch.where(delta < 0.0, -1.0 + ndtw_rew, 0.0))
    move_rew = move_rew - torch.where(
        (last_dist <= 1.0) & (delta < 0.0), (1.0 - last_dist) * 2.0, 0.0)
    return torch.where(ended_pre, 0.0, torch.where(stopped, stop_rew, move_rew))


def a2c_loss(values, rewards, masks, logps, entropys, bootstrap, tcfg,
             n_items, shard: DataShard | None = None):
    """The A2C loss of a rollout (agent_cmt.py:712-744) from its [T, B]
    critic values, rewards, masks and chosen log-probabilities: returns
    discounted by `tcfg.gamma` from `bootstrap` [B], the policy gradient on
    the detached advantage, the 0.5 L2 critic loss, the entropy bonus where
    `entropys` is given, normalised by `tcfg.normalize_loss` ('batch'
    divides by `n_items`, the global item count; 'total' by the mask sum
    over every rank of `shard`)."""
    rl_loss = values.new_zeros(())
    discount = bootstrap
    for s in reversed(range(values.shape[0])):
        discount = discount * tcfg.gamma + rewards[s]
        adv = (discount - values[s]).detach()
        rl_loss = (rl_loss + torch.sum(-logps[s] * adv * masks[s])
                   + torch.sum(((discount - values[s]) ** 2) * masks[s]) * 0.5)
    if entropys is not None:
        rl_loss = rl_loss + torch.sum(
            -tcfg.entropy_loss_weight * entropys * masks)
    if tcfg.normalize_loss == "total":
        rl_loss = rl_loss / torch.clamp(global_sum(torch.sum(masks), shard),
                                        min=1.0)
    elif tcfg.normalize_loss == "batch":
        rl_loss = rl_loss / n_items
    return rl_loss


def _select_action(logits, valid, teacher, feedback: str, rng: Rng | None,
                   il_mask=None):
    """Action slot per item (agent_cmt.py:560-577); under 'sample' and
    'mixed' also its log-probability and the policy entropy, which only the
    RL loss reads.  'mixed': items in `il_mask` take the teacher action, the
    rest sample."""
    if feedback == "teacher":
        return teacher, None, None
    logp = torch.log_softmax(
        torch.where(valid, logits, LOGIT_NEG_INF).float(), dim=-1)
    if feedback == "argmax":
        return torch.argmax(logp, dim=-1).to(torch.int32), None, None
    if feedback not in ("sample", "mixed"):
        raise ValueError(f"feedback {feedback!r}")
    a = sample_categorical(logp, rng)
    if feedback == "mixed":
        a = torch.where(il_mask, teacher.long(), a)
    entropy = -torch.sum(torch.where(valid, logp.exp() * logp, 0.0), dim=-1)
    chosen = logp.gather(1, a.clamp(0, logp.shape[1] - 1)[:, None])[:, 0]
    return a.to(torch.int32), chosen, entropy


def imagination_input(ep: EpisodeBatch, mcfg):
    """What the imagine mode takes: raw images under e2e_imagination, else
    the precomputed features; raises when the episodes lack them."""
    e2e = mcfg.e2e_imagination != "off"
    x = ep.imagine_images if e2e else ep.imagine_feats
    if x is None:
        if e2e:
            raise ValueError(
                "e2e_imagination is on but EpisodeBatch.imagine_images is "
                "None: load raw images (RawImaginationImageBank / "
                "synthetic_episodes(imagine_image_size=...))")
        raise ValueError(
            "imagine_enc_pano is on but EpisodeBatch.imagine_feats is None: "
            "load precomputed imagination features "
            "(ImaginationImageFeaturesDB) or disable imagination")
    return x


def rollout_hamt(model: HamtModel, tables: WorldTables, ep: EpisodeBatch,
                 cfg: Config, rng: Rng | None = None, critic: Critic | None = None,
                 feedback: str = "argmax", train_ml: float | None = None,
                 train_rl: bool = False, deterministic: bool = True,
                 max_steps: int | None = None,
                 early_exit: bool = False,
                 il_mask: torch.Tensor | None = None,
                 shard: DataShard | None = None) -> RolloutResult:
    """Roll out a batch of episodes; tables and ep lie on the model's device.

    feedback: 'argmax' (greedy), 'teacher' (gt-path teacher forcing),
    'sample' (actions drawn from `rng`) or 'mixed' (the fused rollout: the
    items of the [B] bool `il_mask` take the teacher action, the rest
    sample).  train_ml weights the teacher CE; train_rl adds the A2C loss
    (needs `critic`).  `deterministic` turns every dropout off; `rng` is
    needed for dropout and for 'sample' / 'mixed'.  Autograd is on only when
    a loss is asked for.  `shard`: the batch is this rank's block of a
    data-parallel global batch, and the losses are its shares."""
    if feedback in ("teacher", "argmax"):
        train_rl = False
    if feedback == "mixed":
        if il_mask is None:
            raise ValueError("feedback='mixed' needs il_mask")
        if rng is not None:  # the IL half's items, then the RL half's
            rng = rng.grouped(2)
    else:
        il_mask = None
    training = train_ml is not None or train_rl
    if early_exit and training:
        raise ValueError("early_exit is for inference rollouts only")
    if train_rl and critic is None:
        raise ValueError("train_rl needs the critic")
    drop = None if deterministic else rng
    with torch.set_grad_enabled(training):
        return _rollout(model, tables, ep, cfg, rng, drop, critic, feedback,
                        train_ml, train_rl, max_steps, early_exit, il_mask,
                        shard)


def _rollout(model, tables, ep, cfg, rng, drop, critic, feedback, train_ml,
             train_rl, max_steps, early_exit, il_m, shard) -> RolloutResult:
    mcfg, tcfg, ecfg = cfg.model, cfg.train, cfg.env
    B = ep.batch
    n_items = B if shard is None else B * shard.size  # the global batch's
    T = max_steps or ecfg.max_action_len
    K = tables.max_candidates
    ignore = tcfg.ignoreid
    dev = ep.scan.device
    zero = torch.zeros((), device=dev)
    scan = ep.scan.long()
    two_phase = cfg.dataset == "r2r_back" and ep.midstop is not None
    use_obj = (mcfg.obj_feat_size > 0 and tables.obj_feat is not None
               and ep.gt_obj_id is not None)
    # CVDN/NDH supervises with the shortest path to the goal
    shortest = cfg.dataset == "cvdn"

    # ---- per-episode prologue (once; agent_cmt.py:392-496) -----------------
    with span("rollout.prologue"):
        with span("model.language"):
            txt_embeds = model.language(ep.txt_ids, ep.txt_mask, drop)
        aux_loss = zero
        imagine_embeds = None
        if mcfg.imagine_enc_pano:
            with span("model.imagine"):
                imagine_embeds = model.imagine(imagination_input(ep, mcfg),
                                               ep.imagine_mask, drop)
            if mcfg.use_cosine_aux_loss:
                # a fused batch: each half normalised alone, negatives from
                # its own half (one alignment call per rollout in the
                # reference)
                groups = None if il_m is None else (~il_m).to(torch.int32)
                with span("model.align"):
                    aux_loss, imagine_embeds = model.align_with_contrastive_loss(
                        txt_embeds, ep.txt_mask, imagine_embeds,
                        ep.imagine_mask, ep.np_weights, drop, groups=groups,
                        shard=shard)

        with span("model.history"):
            h0 = model.history_initial(B, drop)
            hist_buf = torch.zeros((B, T + 1, mcfg.hidden_size),
                                   dtype=h0.dtype, device=dev)
            hist_buf[:, 0] = h0
            hist_len = torch.ones((B,), dtype=torch.int32, device=dev)
            slots = torch.arange(T + 1, device=dev)

        with span("env.reset"):
            st = envx.reset(tables, ep, T)
            if train_rl:
                dtw_row = envx.dtw_init(tables, ep)
                last_dist = (tables.dist[scan, st.node.long(),
                                         ep.midstop.long()]
                             if two_phase
                             else envx.distance_to_goal(tables, ep, st.node))
                last_ndtw = envx.dtw_ndtw(dtw_row, ep, ecfg.error_margin)
            first_ended = torch.zeros((B,), dtype=torch.bool, device=dev)
            midstop_pred = torch.full((B,), -1, dtype=torch.int32, device=dev)
            obj_pred = torch.full((B,), -1, dtype=torch.int32, device=dev)

    def visual_forward(st, h_buf, h_len):
        with span("env.observe"):
            obs = envx.observe_hamt(tables, ep, st, mcfg.angle_feat_size)
            if ecfg.ob_type == "cand":
                # candidates + [STOP] only (agent_cmt.py:502
                # _candidate_variable)
                obs = obs._replace(valid=obs.valid & (obs.nav_types != 0))
        obj_kw = {}
        if use_obj:
            obj_kw = dict(obj_img_feats=obs.obj_img, obj_ang_feats=obs.obj_ang,
                          obj_valid=obs.obj_valid, obj_pos_feats=obs.obj_pos)
        with span("model.visual"):
            h_mask = slots[None, :] < h_len[:, None]
            out = model.visual(txt_embeds, ep.txt_mask, h_buf, h_mask,
                               obs.img, obs.ang, obs.nav_types, obs.valid,
                               imagine_embeds=imagine_embeds,
                               imagine_mask=ep.imagine_mask, rng=drop, **obj_kw)
        return obs, out

    ml_acc = og_acc = ent_acc = zero
    ys = {k: [] for k in ("logits", "actions", "logp", "entropy", "state",
                          "reward", "mask")}
    t = 0
    for t in range(T):
        spans.count("rollout.steps")
        with span("rollout.step", step=t):
            obs, out = visual_forward(st, hist_buf, hist_len)
            with span("policy.select"):
                act_logits = out.act_logits
                teacher = (envx.teacher_hamt(tables, ep, st, t, ignore,
                                             shortest_teacher=shortest)
                           if feedback in ("teacher", "mixed")
                           or train_ml is not None else None)

                # IL: summed CE with ignore index from the UNMASKED logits,
                # as the reference computes ml_loss before the
                # no_cand_backtrack masking (agent_cmt.py:547 vs :549-558)
                if train_ml is not None:
                    logp = torch.log_softmax(act_logits.float(), dim=-1)
                    tgt = teacher.clamp(0, logp.shape[1] - 1).long()
                    ce = -logp.gather(1, tgt[:, None])[:, 0]
                    ce_skip = teacher == ignore
                    if il_m is not None:
                        ce_skip = ce_skip | ~il_m  # CE: the IL half only
                    ml_acc = ml_acc + torch.sum(torch.where(ce_skip, 0.0, ce))

                if tcfg.no_cand_backtrack:
                    # mask candidates leading to already-visited nodes (incl.
                    # the current one), agent_cmt.py:549-558; the [STOP] slot
                    # stays open
                    cand_nodes = tables.adj[ep.scan.long(), st.node.long()]
                    cols = torch.arange(st.path_nodes.shape[1], device=dev)
                    pos_ok = cols[None, :] < st.path_len[:, None]      # [B, P]
                    bt = torch.any((st.path_nodes[:, None, :]
                                    == cand_nodes[:, :, None])
                                   & pos_ok[:, None, :], dim=-1)       # [B, K]
                    bt_full = torch.nn.functional.pad(
                        bt, (0, act_logits.shape[1] - K))
                    act_logits = torch.where(bt_full, LOGIT_NEG_INF, act_logits)

                a_t, logp_a, entropy = _select_action(
                    act_logits, (obs.nav_types != 0) & obs.valid, teacher,
                    feedback, rng, il_m)
                if entropy is not None:
                    ent_skip = st.ended if il_m is None else st.ended | il_m
                    ent_acc = ent_acc + torch.sum(torch.where(ent_skip, 0.0,
                                                              entropy))

                # stop selected this step / the teacher says ignore (ended)
                stop_sel = a_t == obs.stop_slot
                if feedback in ("teacher", "mixed"):
                    stop_sel = stop_sel | (a_t == ignore)
                stop_sel = stop_sel & ~st.ended
                is_stop = stop_sel | st.ended
                a_env = torch.where(is_stop, K, a_t).to(torch.int32)

                if use_obj:
                    # ref CE when the teacher stops here (= at the goal
                    # viewpoint, reverie/agent.py:150-158); the predicted
                    # object is recorded the step the item stops, the forced
                    # stop at T-1 included
                    gt_match = ((obs.obj_ids == ep.gt_obj_id[:, None])
                                & obs.obj_valid)
                    og_logp = torch.log_softmax(torch.where(
                        obs.obj_valid, out.obj_logits, LOGIT_NEG_INF).float(),
                        dim=-1)
                    if train_ml is not None:
                        sup = ((teacher == obs.stop_slot) & ~st.ended
                               & gt_match.any(1))
                        if il_m is not None:
                            sup = sup & il_m  # grounding CE: the IL half only
                        gt_k = torch.argmax(gt_match.to(torch.int32), dim=1)
                        og_ce = -og_logp.gather(1, gt_k[:, None])[:, 0]
                        og_acc = og_acc + torch.sum(torch.where(sup, og_ce,
                                                                0.0))
                    best_id = envx._take(obs.obj_ids,
                                         torch.argmax(og_logp, dim=1))
                    stopping = stop_sel | ((t == T - 1) & ~st.ended)
                    obj_pred = torch.where(stopping & obs.obj_valid.any(1),
                                           best_id, obj_pred)
                if two_phase:
                    midstop_pred = torch.where(stop_sel & ~first_ended,
                                               st.node, midstop_pred)

            # history token for time t (appended before the env transition)
            with span("env.history_inputs"):
                hist_img, pano_img, pano_ang, prev_ang = envx.history_inputs(
                    tables, ep, st, torch.where(is_stop, -1, a_env),
                    mcfg.angle_feat_size)
            with span("model.history"):
                h_tok = model.history_step(hist_img, prev_ang, t, pano_img,
                                           pano_ang, drop)
                grow = ~st.ended  # just-stopped items still record one token
                write = (slots[None, :] == hist_len[:, None]) & grow[:, None]
                hist_buf = torch.where(write[:, :, None], h_tok[:, None, :],
                                       hist_buf)
                hist_len = torch.where(grow, hist_len + 1, hist_len)

            with span("env.step"):
                ended_pre = st.ended
                st = envx.step_hamt(tables, ep, st, a_env)
                if two_phase:
                    # the first stop records the midstop and goes on
                    # (:275-276)
                    st = st.replace(ended=ended_pre | (stop_sel & first_ended))
                moved = ~is_stop & ~ended_pre

            if train_rl:
                with span("env.reward"):
                    # reward shaping on the updated pose
                    # (agent_cmt.py:615-653); r2r_back targets the midstop
                    # first, then the goal
                    if two_phase:
                        phase_goal = torch.where(first_ended, ep.goal,
                                                 ep.midstop)
                        dist = tables.dist[scan, st.node.long(),
                                           phase_goal.long()]
                    else:
                        dist = envx.distance_to_goal(tables, ep, st.node)
                    new_row = envx.dtw_push(tables, ep, dtw_row, st.node)
                    dtw_row = torch.where(moved[:, None], new_row, dtw_row)
                    ndtw = envx.dtw_ndtw(dtw_row, ep, ecfg.error_margin)
                    reward = shaped_reward(dist, ndtw, last_dist, last_ndtw,
                                           is_stop, ended_pre)
                    if two_phase:
                        # failing to reach the midstop ends the episode
                        # (:252)
                        st = st.replace(ended=st.ended | (
                            stop_sel & ~first_ended & (dist >= 3.0)))
                    last_dist = torch.where(ended_pre, last_dist, dist)
                    last_ndtw = torch.where(moved, ndtw, last_ndtw)
                    mask = torch.where(ended_pre, 0.0, 1.0)
                    if il_m is not None:
                        mask = mask * ~il_m  # RL terms: the sampled half only
                    ys["reward"].append(reward)
                    ys["mask"].append(mask)
                    ys["logp"].append(logp_a)
                    ys["entropy"].append(entropy)
                    ys["state"].append(out.state)
            first_ended = first_ended | stop_sel

            if not early_exit:
                ys["logits"].append(act_logits)
                ys["actions"].append(a_t)
            elif spans.host_read(st.ended.all()):  # one host sync per step
                break

    with span("rollout.epilogue"):
        loss = (mcfg.cosine_weight * aux_loss if mcfg.use_cosine_aux_loss
                else zero)
        ml_loss = rl_loss = og_loss = zero
        if train_ml is not None:
            # per-rollout normalisation (agent_cmt.py:747): a fused batch's CE
            # divides by the IL half's size; both over every rank
            n_il = (n_items if il_m is None
                    else torch.clamp(global_sum(il_m.sum(), shard), min=1))
            ml_loss = ml_acc * train_ml / n_il
            loss = loss + ml_loss
            if use_obj:
                # ref_loss / batch, unweighted by ml_weight
                # (reverie/agent.py:449)
                og_loss = og_acc / n_il
                loss = loss + og_loss

        if train_rl:
            # the final state's value, under stop-gradient
            with torch.no_grad():
                _, last_out = visual_forward(st, hist_buf, hist_len)
                last_value = critic(last_out.state, drop)
            bootstrap = torch.where(st.ended, 0.0, last_value.float())
            states = torch.stack(ys["state"])                    # [T, B, H]
            values = critic(states, drop, batch_dim=1).float()   # [T, B]
            n_rl = (n_items if il_m is None
                    else torch.clamp(global_sum((~il_m).sum(), shard), min=1))
            rl_loss = a2c_loss(
                values, torch.stack(ys["reward"]), torch.stack(ys["mask"]),
                torch.stack(ys["logp"]), torch.stack(ys["entropy"]), bootstrap,
                tcfg, n_rl, shard)
            loss = loss + rl_loss

    return RolloutResult(
        loss=loss, ml_loss=ml_loss, rl_loss=rl_loss, aux_loss=aux_loss,
        path_nodes=st.path_nodes, path_len=st.path_len,
        logits=torch.stack(ys["logits"]) if ys["logits"] else None,
        actions=torch.stack(ys["actions"]) if ys["actions"] else None,
        entropy_sum=ent_acc, steps=t + 1, midstop=midstop_pred,
        og_loss=og_loss, pred_obj=obj_pred)


def make_eval_fn(model: HamtModel, tables: WorldTables, cfg: Config,
                 device=None):
    """Greedy-eval rollout on `device` (the card unless the caller names
    one): episodes -> (path_nodes, path_len), and a third element where
    the task scores one: the grounded object id per item (REVERIE / SOON,
    for RGS) or the declared midstop node (r2r_back, -1 when never
    declared).  Moves the model and the tables there once.
    `eval_fn.steps` is the number of steps the last call's loop ran."""
    dev = resolve_device(device)
    model.to(dev).eval()
    tables = tables.to(dev)
    use_obj = cfg.model.obj_feat_size > 0 and tables.obj_feat is not None

    def eval_fn(ep: EpisodeBatch):
        with span("eval.call"):
            res = rollout_hamt(model, tables, ep.to(dev), cfg, early_exit=True)
        eval_fn.steps = res.steps
        if use_obj:
            return res.path_nodes, res.path_len, res.pred_obj
        if cfg.dataset == "r2r_back":
            return res.path_nodes, res.path_len, res.midstop
        return res.path_nodes, res.path_len

    return eval_fn
