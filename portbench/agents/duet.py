"""DUET-Imagine cells: the program's greedy eval (`DuetTrainer`).

The check replays a sample of the served episodes through the float32
reference along the program's served paths (`reference/duet.py:Replay`):
each appended stretch has to be the map's own path; at every step the
model chose, the logit of the program's choice is read against the
reference's best, and at every stop the stop score of the node it
backtracked to against the best visited one's, in log-probability.  The
means over the sample are compared, the widest gaps reported.  A path
that does not start at the episode's start is an invalid output.
"""

from __future__ import annotations

import numpy as np

from portbench.agents.common import EvalCell as _EvalCell
from portbench.reference import duet as ref
from portbench.reference.common import Numerics, f32_setup

BLOCK = 64  # episodes per reference block


class EvalCell(_EvalCell):
    specs = staticmethod(ref.specs)

    @staticmethod
    def trainer_class():
        from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

        return DuetTrainer

    def failed(self, records) -> int:
        idx, paths, lens = self.items(records)
        ok = (lens >= 1) & (paths[:, 0] == self.w.ep["start_node"][idx])
        return int((~ok).sum())

    def census(self, records) -> dict:
        idx, paths, lens = self.items(records)
        ep = self.w.ep
        steps = ref.walk(self.w.tables(), ep["scan"][idx], ep["start_node"][idx],
                         paths, lens, self.T, self.w.e["max_gmap_nodes"])
        has_np = ep["np_weights"][idx].sum(-1) > 0
        flops, nbytes = ref.census(
            self.w.m, ep["txt_mask"][idx].sum(1), ep["imagine_mask"][idx].sum(1),
            (ep["imagine_mask"][idx] & has_np).sum(1), steps)
        return {"flops": flops, "attention_bytes": nbytes}

    def first_k(self, idx):
        """Candidates at the start of each item's batch's first item."""
        tab, ep = self.w.tables(), self.w.ep
        first = (idx // self.per_call) * self.per_call
        return tab.np_valid[ep["scan"][first], ep["start_node"][first]].sum(-1)

    def replay(self, idx, paths, lens, modes=("float32",)):
        """The sample's readings: every decision's logit gap and every
        backtrack's stop-score gap under the float32 reference, and the
        items whose path is not the map's; with "fp8" in `modes` the same
        gaps of the choices the fp8 reference, replayed along the same
        paths, ranks first (the control)."""
        f32_setup()
        tab = self.w.tables()
        out = {"gaps": [], "stop_gaps": [], "bad": 0, "where": [],
               "control_gaps": [], "control_stop_gaps": []}
        for lo in range(0, len(idx), BLOCK):
            rows, cut = idx[lo:lo + BLOCK], slice(lo, lo + BLOCK)
            runs = {}
            for mode in modes:
                rp = ref.Replay(ref.Duet(self.w.weights, self.w.m, Numerics(mode)),
                                tab, self.w.feat, self.w.rows(rows),
                                self.first_k(rows), self.w.e)
                runs[mode] = (rp, rp.run(paths[cut], lens[cut]))
            rp, bad = runs["float32"]
            out["bad"] += bad
            low = runs["fp8"][0] if "fp8" in runs else None
            for key, (row, choice, nodes) in rp.decisions.items():
                out["gaps"].append(row.max() - row[choice])
                out["where"].append((key[1], nodes))
                if low is not None and key in low.decisions:
                    out["control_gaps"].append(
                        row.max() - row[int(np.argmax(low.decisions[key][0]))])
            for key, (row, choice) in rp.stops.items():
                out["stop_gaps"].append(row.max() - row[choice])
                if low is not None and key in low.stops:
                    out["control_stop_gaps"].append(
                        row.max() - row[int(np.argmax(low.stops[key][0]))])
        return out

    def check(self, records, seed: int, traffic: dict, modes=("float32",)):
        """Readings of the sample: each gap's widest and mean, and the path
        mismatches; with "fp8" among `modes` the control's readings too
        (`control_...`), which the benchmark's own runs do not compute."""
        idx, paths, lens = self.sample(records, seed, traffic["check_items"])
        r = self.replay(idx, paths, lens, modes)
        readings = [("path_mismatch", r["bad"])]
        for name, key in (("logit_gap", "gaps"), ("stop_logit_gap", "stop_gaps")):
            for prefix in ("", "control_"):
                vals = r[prefix + key]
                if vals or not prefix:
                    readings += [(prefix + name, float(max(vals, default=0.0))),
                                 (prefix + "mean_" + name,
                                  float(np.mean(vals)) if vals else 0.0)]
        facts = {"sampled_items": len(idx), "decisions": len(r["gaps"]),
                 "stops": len(r["stop_gaps"])}
        if r["gaps"]:  # the step and map size of the widest logit gap
            facts["widest_at_step_nodes"] = r["where"][int(np.argmax(r["gaps"]))]
        return readings, facts
