"""The port's spans and counters (utils/spans.py) and the benchmark's reading
of them (portbench/spans.py), on the CPU at the tiny test widths; one card
test holds every host synchronisation of greedy eval to a counted
`host_read`.  Imports nothing of JAX, so that the card test runs with
`--noconftest` on a machine without it."""

import numpy as np
import pytest
import torch

from portbench.spans import Attribution, host_table, issue_ns, measure
from vln_imagine_tpu_torch.config import tiny_test_config
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.ops.kernels import (
    launch_counts,
    reset_launch_counts,
)
from vln_imagine_tpu_torch.utils import spans

torch.set_num_threads(2)

HAMT_STEP = {"env.observe", "model.visual", "policy.select",
             "env.history_inputs", "model.history", "env.step",
             "rollout.host_read"}
DUET_STEP = {"map.visit", "model.panorama", "map.update", "map.inputs",
             "model.navigation", "policy.select", "map.path", "env.step",
             "env.observe", "map.grow", "rollout.host_read"}
PROLOGUE = {"hamt": {"model.language", "model.imagine", "model.align",
                     "model.history", "env.reset"},
            "duet": {"model.text", "model.imagine", "model.align",
                     "env.reset", "map.grow"}}


@pytest.fixture(autouse=True)
def spans_off():
    spans.take()
    yield
    spans.take()


def _trainer(agent: str, device="cpu"):
    """A trainer at the tiny widths and its episodes; on the card with two
    heads, so that the head size (32) is one the kernels take."""
    from vln_imagine_tpu_torch.config import _replace
    from vln_imagine_tpu_torch.train.trainer import HamtTrainer
    from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

    cfg = tiny_test_config(agent)
    if device != "cpu":
        cfg = _replace(cfg, "model", num_attention_heads=2)
    world, _ = synthetic_world(num_scans=2, num_nodes=20,
                               max_candidates=cfg.env.max_candidates,
                               views=cfg.env.views,
                               feat_dim=cfg.model.image_feat_size, seed=1)
    ep = synthetic_episodes(world, batch=4,
                            max_gt_path_len=cfg.env.max_gt_path_len,
                            max_instr_len=cfg.env.max_instr_len,
                            max_imaginations=cfg.model.max_imagination_len,
                            vocab_size=cfg.model.vocab_size,
                            feat_dim=cfg.model.hidden_size, seed=2)
    cls = HamtTrainer if agent == "hamt" else DuetTrainer
    return cls(cfg, world, device=device), ep


def test_off_records_nothing_and_returns_one_null_context():
    a, b = spans.span("x"), spans.span("y", step=3)
    assert a is b
    with a, b:
        pass
    assert spans.take() == []


def test_nesting_parents_calls_steps_and_self_time():
    with spans.on():
        with spans.span("root"):
            with spans.span("rollout.step", step=4):
                with spans.span("env.observe"):
                    pass
                with spans.span("model.visual"):
                    pass
        with spans.span("root"):
            pass
    assert spans.span("z") is spans.span("w")  # off again after the block
    recs = spans.take()
    assert [r.name for r in recs] == ["root", "rollout.step", "env.observe",
                                      "model.visual", "root"]
    root, step, obs, vis, root2 = recs
    assert root.parent is None and root2.parent is None
    assert step.parent == root.id and obs.parent == vis.parent == step.id
    assert root.call == step.call == obs.call == vis.call != root2.call
    assert (root.step, step.step, obs.step, vis.step) == (None, 4, 4, 4)
    for outer, inner in ((root, step), (step, obs), (step, vis)):
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert spans.take() == []


def test_self_time_is_duration_less_what_children_cover():
    R = spans.Record
    recs = [R(0, "a", None, 0, None, 0, 100), R(1, "b", 0, 0, None, 10, 30),
            R(2, "c", 0, 0, None, 40, 45), R(3, "d", 1, 0, None, 12, 20)]
    own = spans.self_ns(recs)
    assert own == {0: 75, 1: 12, 2: 5, 3: 8}
    calls, host = host_table(recs, own)
    assert dict(calls) == {"a": 1, "a/b": 1, "a/c": 1, "a/b/d": 1}
    assert dict(host) == {"a": 75, "a/b": 12, "a/c": 5, "a/b/d": 8}
    assert sum(host.values()) == 100


def test_counters_and_launch_counts_share_one_store():
    spans.reset_counts()
    spans.count("x")
    spans.count("x", 4)
    spans.count("launches.attention_fwd", 2)
    assert spans.counts() == {"x": 5, "launches.attention_fwd": 2}
    assert launch_counts() == {"attention_fwd": 2, "attention_dropout_fwd": 0,
                               "attention_dropout_bwd": 0, "attention_bwd": 0,
                               "layer_norm": 0}
    reset_launch_counts()
    assert spans.counts() == {"x": 5}
    assert set(launch_counts().values()) == {0}


def test_host_read_counts_and_reads():
    spans.reset_counts()
    assert spans.host_read(torch.tensor([True, True]).all()) is True
    with spans.on():
        assert spans.host_read(torch.tensor([True, False]).all()) is False
    assert spans.counts()["host_reads"] == 2
    assert [r.name for r in spans.take()] == ["rollout.host_read"]


@pytest.mark.parametrize("agent", ["hamt", "duet"])
def test_eval_paths_are_the_same_with_spans_on(agent):
    trainer, ep = _trainer(agent)
    step = trainer.make_eval_step()
    off = [x.numpy().copy() for x in step(ep)]
    with spans.on():
        on = [x.numpy().copy() for x in step(ep)]
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("agent", ["hamt", "duet"])
def test_each_step_is_one_span_with_its_children(agent):
    trainer, ep = _trainer(agent)
    step = trainer.make_eval_step()
    spans.reset_counts()
    with spans.on():
        step(ep)
        step(ep)
    n = spans.counts()
    recs = spans.take()
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["eval.call", "eval.call"]
    steps = [r for r in recs if r.name == "rollout.step"]
    assert len(steps) == 2 * step.steps == n["rollout.steps"]
    assert n["host_reads"] == n["rollout.steps"]
    want = HAMT_STEP if agent == "hamt" else DUET_STEP
    for s in steps:
        kids = [r.name for r in recs if r.parent == s.id]
        assert set(kids) == want and len(kids) == len(want), kids
        assert by_id[s.parent].name == "eval.call"
    for root in roots:
        kids = [r.name for r in recs if r.parent == root.id]
        assert kids[0] == "rollout.prologue" and kids[-1] == "rollout.epilogue"
        assert kids.count("rollout.step") == step.steps
        pro = next(r for r in recs if r.parent == root.id
                   and r.name == "rollout.prologue")
        assert {r.name for r in recs if r.parent == pro.id} == PROLOGUE[agent]
    # the per-step steps index and the host's issue time
    assert [s.step for s in steps] == list(range(step.steps)) * 2
    assert len(issue_ns(recs)) == len(steps) and min(issue_ns(recs)) > 0


def test_train_step_spans():
    trainer, ep = _trainer("hamt")
    step = trainer.make_train_step("sample")
    with spans.on():
        step(ep, ep)
    recs = spans.take()
    root = next(r for r in recs if r.name == "train.step")
    kids = [r.name for r in recs if r.parent == root.id]
    assert kids == ["train.rollout", "train.rollout", "train.backward",
                    "optim.step"]
    assert {r.name for r in recs} >= {"env.reward", "rollout.epilogue"}


def test_spans_are_profiler_annotations_with_the_same_nesting():
    from torch.profiler import ProfilerActivity, profile

    trainer, ep = _trainer("duet")
    step = trainer.make_eval_step()
    step(ep)
    with spans.on(), profile(activities=[ProfilerActivity.CPU]) as prof:
        step(ep)
    recs = spans.take()
    names = {r.name for r in recs}
    ann = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
           for ev in prof.profiler.kineto_results.events()
           if ev.name() in names]
    att = Attribution(ann, {}, [])
    calls, _ = host_table(recs, spans.self_ns(recs))
    assert dict(att.calls) == dict(calls)


def test_attribution_on_hand_made_events():
    # a call with a step; the step's env span launches 2 ops, its model
    # span one; the prologue one; one op's launch is not in the trace
    ann = [(0, 100, "eval.call"), (5, 20, "rollout.prologue"),
           (20, 90, "rollout.step"), (22, 40, "env.observe"),
           (40, 70, "model.visual")]
    launches = {1: 10, 2: 25, 3: 30, 4: 45, 5: 80}
    device = [(12, 30, 1), (30, 35, 2), (40, 50, 3), (55, 65, 4),
              (85, 95, 5), (96, 98, 99)]
    att = Attribution(ann, launches, device)
    assert att.device_ns == {"eval.call/rollout.prologue": 18,
                             "eval.call/rollout.step/env.observe": 15,
                             "eval.call/rollout.step/model.visual": 10,
                             "eval.call/rollout.step": 10}
    assert att.unlaunched_ns == 2
    assert att.device_under(lambda p: "env.observe" in p) == 15
    # busy [12, 35), [40, 50), [55, 65), [85, 95), [96, 98); the window
    # [0, 100); gaps by their midpoint
    assert att.busy_ns == 23 + 10 + 10 + 10 + 2
    assert dict(att.idle_ns) == {
        "eval.call/rollout.prologue": 12,        # [0, 12), mid 6
        "eval.call/rollout.step/env.observe": 5,   # [35, 40), mid 37.5
        "eval.call/rollout.step/model.visual": 5,  # [50, 55), mid 52.5
        "eval.call/rollout.step": 20,              # [65, 85), mid 75
        "eval.call": 3}                            # [95, 96) + [98, 100)
    assert sum(att.idle_ns.values()) + att.busy_ns == 100
    assert att.idle_under(lambda p: "rollout.step" in p) == 30
    assert att.path_at(-1) is None and att.path_at(100) is None


def test_measure_runs_the_spans_passes_at_tiny_widths(tmp_path, capsys):
    from portbench.tests.tiny import make_root

    root = make_root(tmp_path, agent="duet")
    out = measure(root, "tiny.eval_tiny", 2 ** 31 + 7, device="cpu")
    assert out["host_syncs_per_step"] == 1.0
    assert out["host_issue_ms_per_step"] > 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("portbench spans: ")
    assert '"eval.call/rollout.step/map.inputs"' in line
    assert '"setup.compile_world"' in line and '"setup.init_params"' in line


@pytest.mark.parametrize("metric", ["env_map_device_ms_per_step",
                                    "idle_in_step_ms_per_step",
                                    "host_issue_ms_per_step",
                                    "host_syncs_per_step"])
def test_readers_find_nothing_without_a_named_cell_or_spans(
        metric, tmp_path, monkeypatch):
    """A run that names no cell on its command line reads nothing, and so
    does a program without spans (the parent of these metrics)."""
    import sys

    import portbench.spans as pb
    from portbench.registry import Registry
    from portbench.tests.tiny import make_root

    read = Registry(pb.ROOT).reader(metric + ".eval")
    ctx = type("Ctx", (), {"trace": object(), "kind": "eval"})
    monkeypatch.setattr(pb, "_cache", {})
    monkeypatch.setattr(sys, "argv", ["portbench/run.py", "--trace", "1"])
    assert read(ctx) is None
    monkeypatch.setitem(sys.modules, "vln_imagine_tpu_torch.utils.spans", None)
    root = make_root(tmp_path)
    assert pb.measure(root, "tiny.eval_tiny", 3, device="cpu") is None


@pytest.mark.parametrize("argv", [
    ["--workload", "duet_r2r.eval_b512", "--seed", "4294967311", "--trace", "1"],
    ["--workload=duet_r2r.eval_b512", "--seed=4294967311", "--trace=1"],
    ["--trace", "1", "--seed", "4294967311", "--workload=duet_r2r.eval_b512"],
])
def test_cell_args_reads_either_form_of_the_command_line(argv):
    from portbench.spans import cell_args

    assert cell_args(argv) == ("duet_r2r.eval_b512", 4294967311)


@pytest.mark.cuda
@pytest.mark.parametrize("agent", ["hamt", "duet"])
def test_eval_syncs_only_at_host_reads_on_card(agent):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sync check is a CUDA mode")
    trainer, ep = _trainer(agent, device="cuda")
    ep = ep.to(trainer.device)
    step = trainer.make_eval_step()
    step(ep)  # builds and loads the kernels
    torch.cuda.synchronize()
    spans.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(ep)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    n = spans.counts()
    assert n["host_reads"] == n["rollout.steps"] == step.steps
    assert out[0].is_cuda
