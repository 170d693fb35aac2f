"""HAMT-Imagine cells: the program's greedy eval (`HamtTrainer`).

The check replays a sample of the served episodes through the float32
reference along the program's own actions and reads, at every step, how
far the logit of the action the program took lies below the reference's
best: 0 where they agree.  Every served path is decoded into actions; one
that is no walk of the graph from its start is an invalid output.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.agents.common import EvalCell as _EvalCell
from portbench.reference import hamt as ref
from portbench.reference.common import LOGIT_NEG, Numerics, f32_setup

BLOCK = 64  # episodes per reference block


class EvalCell(_EvalCell):
    specs = staticmethod(ref.specs)

    @staticmethod
    def trainer_class():
        from vln_imagine_tpu_torch.train.trainer import HamtTrainer

        return HamtTrainer

    def decode(self, idx, paths, lens):
        """Action slots [n, T] (K = STOP, -1 past the end) of served paths,
        and a flag per item: False where the path is no walk of the graph
        from the episode's start."""
        tab = self.w.tables()
        T, K = self.T, tab.K
        ep = self.w.ep
        scan = ep["scan"][idx]
        acts = np.full((len(idx), T), -1, np.int64)
        ok = (lens >= 1) & (lens <= T + 1) & (paths[:, 0] == ep["start_node"][idx])
        for t in range(T):
            moving = ok & (t < lens - 1)
            cur, nxt = paths[:, t], paths[:, min(t + 1, paths.shape[1] - 1)]
            hit = (tab.np_adj[scan, cur] == nxt[:, None]) & tab.np_valid[scan, cur]
            ok &= ~moving | hit.any(1)
            acts[:, t] = np.where(moving, hit.argmax(1),
                                  np.where(t == lens - 1, K, -1))
        return acts, ok

    def failed(self, records) -> int:
        return int((~self.decode(*self.items(records))[1]).sum())

    def census(self, records) -> dict:
        idx, paths, lens = self.items(records)
        acts, _ = self.decode(idx, paths, lens)
        ep, tab = self.w.ep, self.w.tables()
        obs_tok, nav_tok = ref.obs_counts(tab)
        scan = ep["scan"][idx][:, None]
        nodes = paths[:, :self.T]
        has_np = ep["np_weights"][idx].sum(-1) > 0
        flops, nbytes = ref.census(
            self.w.m, self.w.e["views"], ep["txt_mask"][idx].sum(1),
            ep["imagine_mask"][idx].sum(1),
            (ep["imagine_mask"][idx] & has_np).sum(1), (acts >= 0).sum(1),
            obs_tok[scan, nodes], nav_tok[scan, nodes])
        return {"flops": flops, "attention_bytes": nbytes}

    def gaps(self, idx, paths, lens, modes=("float32",)):
        """Per mode, the gaps over the sample's served steps between the
        reference's best logit and that of the action taken: the program's
        (float32) or the one the mode's own logits rank first."""
        f32_setup()
        acts, ok = self.decode(idx, paths, lens)
        if not ok.all():
            return {mode: np.array([np.inf]) for mode in modes}
        tab = self.w.tables()
        gaps = {mode: [] for mode in modes}
        for lo in range(0, len(idx), BLOCK):
            a = torch.as_tensor(acts[lo:lo + BLOCK], device=self.w.device)
            ep = self.w.rows(idx[lo:lo + BLOCK])
            served = a.T >= 0                                        # [T, B]
            base = best = None
            for mode in ("float32",) + tuple(m for m in modes if m != "float32"):
                model = ref.Hamt(self.w.weights, self.w.m, Numerics(mode))
                lg = ref.forced_logits(model, tab, self.w.feat, ep, a)
                if base is None:
                    base, best = lg, lg.max(-1).values
                    chosen = a.T.clamp(min=0)
                else:
                    chosen = lg.argmax(-1)
                took = base.gather(-1, chosen[..., None])[..., 0]
                gap = torch.where(took > LOGIT_NEG / 2, best - took, np.inf)
                if mode in modes:
                    gaps[mode].append(gap[served].cpu().numpy())
        return {mode: np.concatenate(g) for mode, g in gaps.items()}

    def check(self, records, seed: int, traffic: dict, modes=("float32",)):
        """Readings of the sample: the widest and the mean logit gap of
        the served actions; with "fp8" among `modes` the control's too
        (`control_...`), which the benchmark's own runs do not compute."""
        idx, paths, lens = self.sample(records, seed, traffic["check_items"])
        gaps = self.gaps(idx, paths, lens, modes)
        readings = []
        for mode, prefix in (("float32", ""), ("fp8", "control_")):
            if mode in gaps:
                readings += [(prefix + "logit_gap", float(gaps[mode].max())),
                             (prefix + "mean_logit_gap", float(gaps[mode].mean()))]
        return readings, {"sampled_items": len(idx),
                          "served_steps": len(gaps["float32"])}
