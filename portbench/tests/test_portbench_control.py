"""The control: the float32 reference with its linear layers in fp8 e4m3,
put in the program's place, has to fail the check's limit.

On the card (`cuda` marker) at the cell's own size: one seed of each eval
cell, the program's reading under its limit and the control's above it.
On the CPU at the tiny widths: the control path runs and reads wider gaps
than the float32 program."""

from __future__ import annotations

import gc
import json
from pathlib import Path

import pytest
import torch

from portbench.registry import Registry
from portbench.tests.tiny import make_root

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's size")
    return torch.device("cuda")


def _readings(reg, workload, seed, device):
    wl = reg.workload(workload)
    config, traffic = reg.config(wl["config"]), reg.traffic(wl["traffic"])
    cell = getattr(reg.agent(config), traffic["cell"])(config, traffic, seed, device)
    outs = [(i, cell.call(i)) for i in range(traffic["split"] // cell.per_call)]
    records = [cell.record(i, o) for i, o in outs]
    del outs
    cell.free_program()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings, _ = cell.check(records, seed, traffic, ("float32", "fp8"))
    return dict(readings)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["hamt_r2r.eval_b512", "duet_r2r.eval_b512"])
def test_the_control_fails_the_limit_on_the_card(card, workload):
    reg = Registry(REPO)
    if workload not in [w["name"] for w in reg.bench["workloads"]]:
        pytest.skip(f"{workload} is not a cell of BENCHMARK.json")
    limits = reg.limits(workload)
    readings = _readings(reg, workload, 2 ** 31 + 77, card)
    # the control fails one of the cell's numbers; the program none
    assert all(readings[k] <= v for k, v in limits.items())
    assert any(readings["control_" + k] > v for k, v in limits.items()
               if "control_" + k in readings)


@pytest.mark.parametrize("agent", ["hamt", "duet"])
def test_the_control_reads_wider_gaps_than_the_program(tmp_path, agent):
    root = make_root(tmp_path, agent=agent, split=16)
    root.joinpath("portbench", "traffic", "eval_tiny.json").write_text(json.dumps(
        dict(json.loads(root.joinpath("portbench", "traffic",
                                      "eval_tiny.json").read_text()),
             check_items=16)))
    readings = _readings(Registry(root), "tiny.eval_tiny", 2 ** 31 + 7,
                         torch.device("cpu"))
    assert readings["logit_gap"] < 1e-4 < readings["control_logit_gap"]
