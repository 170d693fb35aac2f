"""DUET-Imagine cells with detector objects: the program's greedy eval
(`DuetTrainer`) on a world whose nodes hold objects.

Set-up adds to DUET's world, from the seed: each node's objects (the
configuration's `max_objects` slots, of them uniform over the traffic's
`objects` range valid; features of the configuration's `obj_feat_size`,
N(0, 0.25) on the device; headings and elevations; ids unique in a scan)
and each episode's target, one of its goal node's objects.  The program's
world holds the same tables.

The check is DUET's, with the reference of `reference/duet_obj.py`, plus
the grounding: the program's grounded object (the eval step's third
output, carried as the last column of a record's paths) read against the
reference's og logits at the node the item ends on, where the item last
stood there: `mean_og_logit_gap`, how far the reference's logit of the
program's object lies below its best (the control's: of the object the
fp8 reference ranks first), and `invalid_objects`, served items whose
grounded id is not one of the objects their end node shows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import worldgen
from portbench.agents import duet
from portbench.reference import duet as ref
from portbench.reference import duet_obj as oref
from portbench.reference.common import Numerics

BLOCK = duet.BLOCK


def draw_objects(seed: int, graphs, ep: dict, slots: int, dim: int,
                 valid_range, device) -> dict:
    """Object tables [S, N, slots, ...] and the episodes' targets (numpy,
    but the features: N(0, 0.25) on `device`)."""
    rng = np.random.default_rng([seed, 4])
    S, N = len(graphs), max(len(xyz) for _, xyz, _ in graphs)
    lo, hi = valid_range
    count = rng.integers(lo, hi + 1, (S, N))
    valid = np.arange(slots)[None, None, :] < count[:, :, None]
    ids = np.where(valid, np.arange(N)[None, :, None] * slots
                   + np.arange(slots)[None, None, :], -1).astype(np.int32)
    ang = np.stack([rng.uniform(-np.pi, np.pi, (S, N, slots)),
                    rng.uniform(-0.4, 0.4, (S, N, slots))], -1).astype(np.float32)
    goal = ep["gt_path"][np.arange(len(ep["scan"])), ep["gt_len"] - 1]
    pick = (rng.random(len(goal)) * count[ep["scan"], goal]).astype(np.int64)
    return {"feat": worldgen.draw_features(seed, (S, N, slots, dim), device,
                                           stream=2),
            "ang": ang, "valid": valid, "ids": ids,
            "target": ids[ep["scan"], goal, pick]}


class EvalCell(duet.EvalCell):
    specs = staticmethod(oref.specs)

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.seed, self.max_objects = seed, config["max_objects"]
        self.valid_range = traffic["objects"]["valid"]
        super().__init__(config, traffic, seed, device)
        # drawn inside `program_s`, while the trainer is built
        self.setup_parts["objects_s"] = self.objects_s

    def trainer_class(self):
        """`DuetTrainer`, built on the program's world with the seed's
        objects, which are drawn here (the base world stands by now) and
        given to the episodes as targets."""
        trainer = duet.EvalCell.trainer_class()
        t0 = time.perf_counter()
        w = self.w
        o = draw_objects(self.seed, w.graphs, w.ep, self.max_objects,
                         w.m["obj_feat_size"], self.valid_range, w.device)
        w.ep["gt_obj_id"] = o.pop("target")
        self.obj = {k: torch.as_tensor(v, device=w.device) for k, v in o.items()}
        self.objects_s = time.perf_counter() - t0

        def build(cfg, world, **kw):
            return trainer(cfg, world.replace(
                obj_feat=self.obj["feat"], obj_ang=self.obj["ang"],
                obj_valid=self.obj["valid"], obj_ids=self.obj["ids"]), **kw)

        return build

    def record(self, i: int, out):
        """DUET's record, the grounded object ids as the paths' last column
        (past every path's length, so nothing else reads it)."""
        paths, lens, pred = out[:3]
        paths = torch.cat([paths, pred[:, None].to(paths.dtype)], 1)
        return (i % len(self.batches), paths.cpu().numpy(), lens.cpu().numpy())

    def census(self, records) -> dict:
        idx, paths, lens = self.items(records)
        ep = self.w.ep
        steps = ref.walk(self.w.tables(), ep["scan"][idx], ep["start_node"][idx],
                         paths, lens, self.T, self.w.e["max_gmap_nodes"])
        nodes = oref.step_nodes(ep["start_node"][idx], paths, lens,
                                [len(s) for s in steps])
        count = self.obj["valid"].sum(-1).cpu().numpy()
        objects = [count[ep["scan"][i], n].tolist() for i, n in zip(idx, nodes)]
        has_np = ep["np_weights"][idx].sum(-1) > 0
        flops, nbytes, tokens = oref.census(
            self.w.m, ep["txt_mask"][idx].sum(1), ep["imagine_mask"][idx].sum(1),
            (ep["imagine_mask"][idx] & has_np).sum(1), steps, objects)
        return {"flops": flops, "attention_bytes": nbytes,
                "object_tokens": tokens}

    def invalid_objects(self, records) -> int:
        """Served items whose grounded id their end node does not show."""
        idx, paths, lens = self.items(records)
        end = paths[np.arange(len(idx)), lens - 1]
        scan = self.w.ep["scan"][idx]
        ids = self.obj["ids"].cpu().numpy()[scan, end]
        valid = self.obj["valid"].cpu().numpy()[scan, end]
        shown = ((ids == paths[:, -1:]) & valid).any(1)
        return int((~shown).sum())

    def replay(self, idx, paths, lens, modes=("float32",)):
        """DUET's readings under the object reference, and each item's
        grounding gap at its end node (`og_gaps`; `control_og_gaps` the
        fp8 reference's first-ranked object's)."""
        tab = self.w.tables()
        out = {"gaps": [], "stop_gaps": [], "bad": 0, "where": [],
               "control_gaps": [], "control_stop_gaps": [], "og_gaps": [],
               "control_og_gaps": [], "grounded": []}
        for lo in range(0, len(idx), BLOCK):
            rows, cut = idx[lo:lo + BLOCK], slice(lo, lo + BLOCK)
            runs = {}
            for mode in modes:
                rp = oref.Replay(oref.ObjDuet(self.w.weights, self.w.m, Numerics(mode)),
                                 tab, self.w.feat, self.obj, self.w.rows(rows),
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
            for b, (p, n) in enumerate(zip(paths[cut], lens[cut])):
                end, pred = int(p[n - 1]), int(p[-1])
                if end not in rp.ground[b]:
                    continue  # a path the reference's map does not take
                row, ids = rp.ground[b][end]
                hit = np.flatnonzero((ids == pred) & np.isfinite(row))
                best = int(np.argmax(row))
                out["grounded"].append((pred, int(ids[best])))
                if len(hit):
                    out["og_gaps"].append(row.max() - row[hit[0]])
                if low is not None and end in low.ground[b]:
                    out["control_og_gaps"].append(
                        row.max() - row[int(np.argmax(low.ground[b][end][0]))])
        self.grounding = out
        return out

    def check(self, records, seed: int, traffic: dict, modes=("float32",)):
        """DUET's readings, then the grounding's: its widest and mean gap
        (and the control's), and `invalid_objects` over every served item."""
        readings, facts = super().check(records, seed, traffic, modes)
        r = self.grounding
        for prefix in ("", "control_"):
            vals = r[prefix + "og_gaps"]
            if vals or not prefix:
                readings += [(prefix + "og_logit_gap", float(max(vals, default=0.0))),
                             (prefix + "mean_og_logit_gap",
                              float(np.mean(vals)) if vals else 0.0)]
        readings.append(("invalid_objects", self.invalid_objects(records)))
        facts["grounded_items"] = len(r["og_gaps"])
        return readings, facts
