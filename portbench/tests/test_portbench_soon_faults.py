"""The object cell with the timed path broken underneath has to come out not
correct.

Whole runs at the tiny widths on the CPU (`tiny_soon.py`: objects 48 wide
beside 32-wide views), each with one fault planted in the program: object
features truncated to the view width and embedded with the views, as the
port did before objects kept their own width; the grounded object altered
where the policy produces it (each node's best object pushed below the
others); or a grounded id that the end node does not show.  A run of the
program as it is comes out correct, and the objects' readers find their
counts on the CPU."""

from __future__ import annotations

import json
import time

import pytest
import torch

from portbench.run import run_cell
from portbench.tests.tiny_soon import SLOTS, make_soon_root

SEED = 2 ** 31 + 303


def _truncated_objects(monkeypatch):
    from vln_imagine_tpu_torch.models.duet import DuetModel

    pano = DuetModel.panorama_per_step

    def broken(self, view_img_fts, loc_fts, nav_types, valid, rng=None,
               obj_img_fts=None):
        cut = obj_img_fts[..., :view_img_fts.shape[-1]]
        return pano(self, torch.cat([view_img_fts, cut], 1), loc_fts,
                    nav_types, valid, rng)

    monkeypatch.setattr(DuetModel, "panorama_per_step", broken)


def _altered_grounding(monkeypatch):
    from vln_imagine_tpu_torch.models.duet import DuetModel

    nav = DuetModel.navigation_per_step

    def broken(self, *a, **kw):
        out = nav(self, *a, **kw)
        lg = out.obj_logits.clone()
        rows = torch.arange(lg.shape[0])
        lg[rows, lg.argmax(-1)] -= 100.0
        return out._replace(obj_logits=lg)

    monkeypatch.setattr(DuetModel, "navigation_per_step", broken)


def _foreign_object(monkeypatch):
    from vln_imagine_tpu_torch.train import rollout_duet

    rollout = rollout_duet.rollout_duet

    def broken(*a, **kw):
        res = rollout(*a, **kw)
        return res._replace(pred_obj=torch.full_like(res.pred_obj, -1))

    monkeypatch.setattr(rollout_duet, "rollout_duet", broken)


FAULTS = {"truncated_objects": _truncated_objects,
          "altered_grounding": _altered_grounding,
          "foreign_object": _foreign_object}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_a_broken_object_path_is_not_correct(tmp_path, monkeypatch, fault):
    root = make_soon_root(tmp_path, monkeypatch)
    if fault is not None:
        FAULTS[fault](monkeypatch)
    r = run_cell(root, "tiny.eval_tiny", SEED, 0.3, False, device="cpu",
                 t_start=time.perf_counter())
    assert r["correct"] is (fault is None), r["compared"]
    failed = {k for k, c in r["compared"].items() if c["value"] > c["limit"]}
    if fault == "truncated_objects":
        assert "mean_logit_gap" in failed
    elif fault == "altered_grounding":
        assert failed == {"mean_og_logit_gap"}
    elif fault == "foreign_object":
        assert failed == {"invalid_objects"}


def test_the_object_readers_count_on_the_cpu(tmp_path, monkeypatch, capsys):
    from portbench.objects import measure

    root = make_soon_root(tmp_path, monkeypatch)
    out = measure(root, "tiny.eval_tiny", SEED, device="cpu")
    # no device trace on the CPU; the slots are B x Ko a step of each call
    assert set(out) == {"object_slot_fill"}
    assert 0 < out["object_slot_fill"] <= 100
    line = capsys.readouterr().out.splitlines()[-1]
    assert line.startswith("portbench objects: ")
    facts = json.loads(line.split(": ", 1)[1])
    assert facts["object_slots"] % (4 * SLOTS) == 0
    assert facts["object_tokens"] <= facts["object_slots"]
