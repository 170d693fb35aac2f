"""A run with the timed path broken underneath has to come out not correct.

Each test drives a whole run at the tiny widths on the CPU (the harness's
look for a card skipped), with one fault planted in the program: the
actions altered where the policy produces them, or half of each batch left out of
the rollout (those items get no step and stand at their start).  A run of
the program as it is comes out correct."""

from __future__ import annotations

import time

import pytest
import torch

from portbench.run import run_cell
from portbench.tests.tiny import LIMITS, make_root

SEED = 2 ** 31 + 101


def _run(tmp_path, agent):
    root = make_root(tmp_path, agent=agent, limits=LIMITS[agent])
    return run_cell(root, "tiny.eval_tiny", SEED, 0.3, False, device="cpu",
                    t_start=time.perf_counter())


def _demote_best(logits):
    """Each row's best entry pushed below the others."""
    rows = torch.arange(logits.shape[0])
    logits = logits.clone()
    logits[rows, logits.argmax(-1)] -= 100.0
    return logits


def _altered_action(monkeypatch, agent):
    if agent == "hamt":
        from vln_imagine_tpu_torch.models.hamt import HamtModel

        visual = HamtModel.visual

        def broken(self, *a, **kw):
            out = visual(self, *a, **kw)
            return out._replace(act_logits=_demote_best(out.act_logits))

        monkeypatch.setattr(HamtModel, "visual", broken)
    else:
        from vln_imagine_tpu_torch.models.duet import DuetModel

        nav = DuetModel.navigation_per_step

        def broken(self, *a, **kw):
            out = nav(self, *a, **kw)
            return out._replace(fused_logits=_demote_best(out.fused_logits))

        monkeypatch.setattr(DuetModel, "navigation_per_step", broken)


def _half_left_out(monkeypatch, agent):
    from vln_imagine_tpu_torch.envx.tables import EpisodeBatch
    from vln_imagine_tpu_torch.train import rollout_duet, rollout_hamt

    mod, name = ((rollout_hamt, "rollout_hamt") if agent == "hamt"
                 else (rollout_duet, "rollout_duet"))
    rollout = getattr(mod, name)

    def broken(model, tables, ep, cfg, **kw):
        half = ep.batch // 2
        first = EpisodeBatch(**{f: None if getattr(ep, f) is None
                                else getattr(ep, f)[:half]
                                for f in ep.__dataclass_fields__})
        res = rollout(model, tables, first, cfg, **kw)
        rest = ep.batch - half
        paths = torch.zeros((rest, res.path_nodes.shape[1]),
                            dtype=res.path_nodes.dtype)
        paths[:, 0] = ep.start_node[half:]
        return res._replace(
            path_nodes=torch.cat([res.path_nodes, paths]),
            path_len=torch.cat([res.path_len, torch.ones(rest, dtype=res.path_len.dtype)]))

    monkeypatch.setattr(mod, name, broken)


@pytest.mark.parametrize("agent", ["hamt", "duet"])
@pytest.mark.parametrize("fault", [None, "altered_action", "half_left_out"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, agent, fault):
    if fault == "altered_action":
        _altered_action(monkeypatch, agent)
    elif fault == "half_left_out":
        _half_left_out(monkeypatch, agent)
    r = _run(tmp_path, agent)
    assert r["correct"] is (fault is None), r["compared"]
