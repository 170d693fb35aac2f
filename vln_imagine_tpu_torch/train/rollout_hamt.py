"""Batched HAMT episode rollout, eval half: greedy (argmax) actions.

The port of `vln_imagine_tpu/train/rollout_hamt.py`.  The reference's
rollout (VLN-HAMT/finetune_src/r2r/agent_cmt.py:371-759) alternates host
feature packing, per-item simulator calls and CUDA forwards; here every step
is tensor code on one device: observation, visual forward, action
selection, history update and env transition.

Semantics kept from the JAX package:
- items that pick STOP still append one history token but freeze afterwards
  (agent_cmt.py:586-609)
- the history buffer has T+1 fixed slots written under a mask, so the step
  body keeps static shapes
- early exit is the reference's python `break` (agent_cmt.py:658-659): the
  loop checks once per step whether every item has ended, which costs one
  host sync per step.  The IL/RL training half waits for the training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vln_imagine_tpu_torch.config import Config
from vln_imagine_tpu_torch.envx import env as envx
from vln_imagine_tpu_torch.envx.tables import EpisodeBatch, WorldTables
from vln_imagine_tpu_torch.models.hamt import HamtModel
from vln_imagine_tpu_torch.ops.masks import LOGIT_NEG_INF
from vln_imagine_tpu_torch.platform import resolve_device


class RolloutResult(NamedTuple):
    aux_loss: torch.Tensor          # scalar cosine alignment loss
    path_nodes: torch.Tensor        # [B, T+1]
    path_len: torch.Tensor          # [B]
    logits: torch.Tensor | None     # [T, B, T_obs] (None under early exit)
    actions: torch.Tensor | None    # [T, B]
    steps: int                      # steps the loop ran


def _select_action(logits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy action slot (agent_cmt.py:560-577, feedback='argmax'): the
    first maximum of the masked log-softmax, as jnp.argmax."""
    logp = torch.log_softmax(
        torch.where(valid, logits, LOGIT_NEG_INF).float(), dim=-1)
    return torch.argmax(logp, dim=-1).to(torch.int32)


@torch.no_grad()
def rollout_hamt(model: HamtModel, tables: WorldTables, ep: EpisodeBatch,
                 cfg: Config, max_steps: int | None = None,
                 early_exit: bool = True) -> RolloutResult:
    """Greedy rollout of a batch of episodes; tables and ep lie on the
    model's device."""
    mcfg, tcfg, ecfg = cfg.model, cfg.train, cfg.env
    B = ep.batch
    T = max_steps or ecfg.max_action_len
    K = tables.max_candidates
    dev = ep.scan.device

    # ---- per-episode prologue (once; agent_cmt.py:392-496) -----------------
    txt_embeds = model.language(ep.txt_ids, ep.txt_mask)
    aux_loss = torch.zeros((), device=dev)
    imagine_embeds = None
    if mcfg.imagine_enc_pano:
        imagine_embeds = model.imagine(ep.imagine_feats, ep.imagine_mask)
        if mcfg.use_cosine_aux_loss:
            aux_loss, imagine_embeds = model.align_with_contrastive_loss(
                txt_embeds, ep.txt_mask, imagine_embeds, ep.imagine_mask,
                ep.np_weights)

    h0 = model.history_initial(B)
    hist_buf = torch.zeros((B, T + 1, mcfg.hidden_size), dtype=h0.dtype,
                           device=dev)
    hist_buf[:, 0] = h0
    hist_len = torch.ones((B,), dtype=torch.int32, device=dev)
    slots = torch.arange(T + 1, device=dev)

    st = envx.reset(tables, ep, T)
    logits_seq, actions = [], []
    t = 0
    for t in range(T):
        obs = envx.observe_hamt(tables, ep, st, mcfg.angle_feat_size)
        if ecfg.ob_type == "cand":
            # candidates + [STOP] only (agent_cmt.py:502 _candidate_variable)
            obs = obs._replace(valid=obs.valid & (obs.nav_types != 0))
        h_mask = slots[None, :] < hist_len[:, None]
        out = model.visual(txt_embeds, ep.txt_mask, hist_buf, h_mask,
                           obs.img, obs.ang, obs.nav_types, obs.valid,
                           imagine_embeds=imagine_embeds,
                           imagine_mask=ep.imagine_mask)
        act_logits = out.act_logits
        if tcfg.no_cand_backtrack:
            # mask candidates leading to already-visited nodes (incl. the
            # current one), agent_cmt.py:549-558; the [STOP] slot stays open
            cand_nodes = tables.adj[ep.scan.long(), st.node.long()]      # [B, K]
            cols = torch.arange(st.path_nodes.shape[1], device=dev)
            pos_ok = cols[None, :] < st.path_len[:, None]                # [B, P]
            bt = torch.any((st.path_nodes[:, None, :] == cand_nodes[:, :, None])
                           & pos_ok[:, None, :], dim=-1)                 # [B, K]
            bt_full = torch.nn.functional.pad(bt, (0, act_logits.shape[1] - K))
            act_logits = torch.where(bt_full, LOGIT_NEG_INF, act_logits)

        a_t = _select_action(act_logits, (obs.nav_types != 0) & obs.valid)
        stop_sel = (a_t == obs.stop_slot) & ~st.ended
        is_stop = stop_sel | st.ended
        a_env = torch.where(is_stop, K, a_t).to(torch.int32)

        # history token for time t (appended before the env transition)
        hist_img, pano_img, pano_ang, prev_ang = envx.history_inputs(
            tables, ep, st, torch.where(is_stop, -1, a_env),
            mcfg.angle_feat_size)
        h_tok = model.history_step(hist_img, prev_ang, t, pano_img, pano_ang)
        grow = ~st.ended  # just-stopped items still record one token
        write = (slots[None, :] == hist_len[:, None]) & grow[:, None]
        hist_buf = torch.where(write[:, :, None], h_tok[:, None, :], hist_buf)
        hist_len = torch.where(grow, hist_len + 1, hist_len)

        st = envx.step_hamt(tables, ep, st, a_env)
        if not early_exit:
            logits_seq.append(act_logits)
            actions.append(a_t)
        elif bool(st.ended.all()):  # one host sync per step
            break
    return RolloutResult(
        aux_loss=aux_loss, path_nodes=st.path_nodes, path_len=st.path_len,
        logits=torch.stack(logits_seq) if logits_seq else None,
        actions=torch.stack(actions) if actions else None,
        steps=t + 1)


def make_eval_fn(model: HamtModel, tables: WorldTables, cfg: Config,
                 device=None):
    """Greedy-eval rollout on `device` (the card unless the caller names
    one): episodes -> (path_nodes, path_len).  Moves the model and the
    tables there once."""
    dev = resolve_device(device)
    model.to(dev).eval()
    tables = tables.to(dev)

    def eval_fn(ep: EpisodeBatch):
        res = rollout_hamt(model, tables, ep.to(dev), cfg, early_exit=True)
        return res.path_nodes, res.path_len

    return eval_fn
