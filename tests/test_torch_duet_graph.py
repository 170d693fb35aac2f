"""DUET's greedy-eval step replayed as one CUDA graph
(`train/rollout_duet.py`: `StepGraph`, `StepGraphs`, `graph_engages`).

On the CPU, at the tiny widths (an R2R world, and a SOON world whose
objects are wider than the views):
- the graph's body, the shared `_step` run on a `StepGraph`'s buffers with
  a 0-d tensor for the step's number, gives the eager loop's results (an
  int step) exactly, also when two batches alternate on one set of
  buffers;
- the engagement rule picks the eager loop for autograd, spans, data
  parallelism, the CPU, sampling, dropout and a loop without early exit;
- buffers, counters held aside and the graphs' keys.

On the card (marker `cuda`; `python -m pytest --noconftest -m cuda
tests/test_torch_duet_graph.py`), at `duet_r2r_config` and
`soon_butd_config` widths on a world of a 5-node and a 96-node scan: a
graph-served `make_eval_fn` call equals the eager loop bit for bit
(paths, lengths, grounded objects, the stop table) at B 8 and B 64, over
batches that end at different steps; a call's outputs survive the next
call; the peak memory stays within 1 % of the eager loop's; every step of
a call after the capture is a replay, and the launch counts are the
eager loop's.  Imports nothing of JAX.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from portbench.tests.tiny_soon import OBJ_DIM, SLOTS, tiny_soon_config
from vln_imagine_tpu_torch.config import (
    duet_r2r_config,
    soon_butd_config,
    tiny_test_config,
)
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.envx.compiler import compile_world
from vln_imagine_tpu_torch.envx.synthetic import random_scan_graph
from vln_imagine_tpu_torch.envx.tables import EnvState, EpisodeBatch
from vln_imagine_tpu_torch.ops.kernels import (
    launch_counts,
    reset_launch_counts,
)
from vln_imagine_tpu_torch.train import rollout_duet as rd
from vln_imagine_tpu_torch.train.rollout_duet import (
    StepGraph,
    StepGraphs,
    graph_engages,
    make_eval_fn,
    rollout_duet,
)
from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer
from vln_imagine_tpu_torch.utils import spans

torch.set_num_threads(2)

STOP_TABLE = ("stop_nodes", "stop_scores", "stop_valid")


def _world(cfg, small_nodes: int = 0, large_nodes: int = 20, objects=0,
           obj_dim=None):
    """Two scans of random graphs with view features (and objects); with
    `small_nodes`, scan 0 is a graph of that many nodes, where the map runs
    out of unvisited nodes, and so the loop ends, within that many steps."""
    world, graphs = synthetic_world(
        num_scans=2, num_nodes=large_nodes,
        max_candidates=cfg.env.max_candidates, views=cfg.env.views,
        feat_dim=cfg.model.image_feat_size, seed=1, max_objects=objects,
        obj_feat_dim=obj_dim)
    if small_nodes:
        small = random_scan_graph(np.random.default_rng(3), "small",
                                  small_nodes)
        nav = compile_world([small, graphs[1]],
                            max_candidates=cfg.env.max_candidates,
                            views=cfg.env.views)
        world = world.replace(**{
            f.name: getattr(nav, f.name) for f in dataclasses.fields(nav)
            if getattr(nav, f.name) is not None})
    return world


def _episodes(world, cfg, batch: int, seed: int = 2) -> EpisodeBatch:
    return synthetic_episodes(world, batch=batch,
                              max_gt_path_len=cfg.env.max_gt_path_len,
                              max_instr_len=cfg.env.max_instr_len,
                              max_imaginations=cfg.model.max_imagination_len,
                              vocab_size=cfg.model.vocab_size,
                              feat_dim=cfg.model.hidden_size, seed=seed)


def _rows(ep: EpisodeBatch, idx) -> EpisodeBatch:
    return dataclasses.replace(ep, **{
        f.name: None if getattr(ep, f.name) is None
        else np.asarray(getattr(ep, f.name))[idx]
        for f in dataclasses.fields(ep)})


def _assert_same(a, b):
    """Two rollout results, field by field, bit for bit."""
    assert a.steps == b.steps
    for k in ("path_nodes", "path_len", "pred_obj", "entropy_sum",
              *STOP_TABLE):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and torch.equal(x, y), k


# ------------------------------------------------------------------ CPU
def _tiny(kind: str):
    if kind == "r2r":
        cfg = tiny_test_config("duet")
        world = _world(cfg)
    else:
        cfg = tiny_soon_config(OBJ_DIM)
        world = _world(cfg, objects=SLOTS, obj_dim=OBJ_DIM)
    tr = DuetTrainer(cfg, world, device="cpu")
    return tr.model.eval(), tr.tables, cfg, world


def _graph_body(graph: StepGraph, model, tables, cfg, ep):
    """`StepGraph.run`'s loop with its step run eagerly, as the capture
    records it: the shared `_step` on the graph's buffers, the step's
    number a 0-d int32 tensor; the result as `_rollout` returns it."""
    run = rd._run_of(model, tables, ep, cfg)
    s = rd._Held(graph)
    zero = torch.zeros(())
    with torch.no_grad():
        aux = rd._prologue(run, s, ep, zero, None)
        t = graph.hold("t", torch.zeros((), dtype=torch.int32))
        done = graph.hold("done", torch.zeros((), dtype=torch.bool))
        for steps in range(1, run.T + 1):
            graph.advance(run, s, t, done)
            if spans.host_read(done):
                break
        res = rd._epilogue(run, s, zero, aux, steps, [], [], {}, None, None)
    return res._replace(**{k: getattr(res, k).clone() for k in (
        "path_len", "entropy_sum", *STOP_TABLE[:2], "pred_obj")})


@pytest.mark.parametrize("kind", ["r2r", "soon"])
def test_step_on_buffers_with_a_tensor_step_is_the_eager_loop(kind):
    model, tables, cfg, world = _tiny(kind)
    a = _episodes(world, cfg, 4, seed=2).to("cpu")
    b = _episodes(world, cfg, 4, seed=5).to("cpu")
    want = {k: rollout_duet(model, tables, ep, cfg, early_exit=True)
            for k, ep in (("a", a), ("b", b))}
    assert (want["a"].pred_obj >= 0).all() == (kind == "soon")
    graph = StepGraph()
    first = _graph_body(graph, model, tables, cfg, a)
    _assert_same(first, want["a"])
    n_bufs = len(graph.bufs)
    # a second batch and the first again on the same buffers
    _assert_same(_graph_body(graph, model, tables, cfg, b), want["b"])
    _assert_same(_graph_body(graph, model, tables, cfg, a), want["a"])
    _assert_same(first, want["a"])
    assert len(graph.bufs) == n_bufs  # allocated once


@pytest.mark.parametrize("kind", ["r2r", "soon"])
def test_eager_loop_with_an_int_or_a_tensor_step(kind):
    """`_step` on a plain state gives the same loop state whether the step's
    number is an int or a 0-d tensor."""
    model, tables, cfg, world = _tiny(kind)
    ep = _episodes(world, cfg, 4, seed=7).to("cpu")
    run = rd._run_of(model, tables, ep, cfg)
    states = []
    for as_tensor in (False, True):
        s = rd._State()
        with torch.no_grad():
            rd._prologue(run, s, ep, torch.zeros(()), None)
            for t in range(run.T):
                rd._step(run, s, torch.tensor(t, dtype=torch.int32)
                         if as_tensor else t)
                if s.st.ended.all():
                    break
        states.append(s)
    for name in rd._State.__slots__:
        x, y = getattr(states[0], name), getattr(states[1], name)
        flat = [(x, y)] if torch.is_tensor(x) else (
            [(getattr(x, f.name), getattr(y, f.name))
             for f in dataclasses.fields(x)] if dataclasses.is_dataclass(x)
            else list(zip(x, y)) if isinstance(x, tuple) else [])
        for u, v in flat:
            if torch.is_tensor(u):
                assert torch.equal(u, v), name


CARD = dict(device=torch.device("cuda"), training=False, early_exit=True,
            shard=None, feedback="argmax", drop=None,
            model=torch.nn.Linear(2, 2))


def _split_model():
    """A model with a parameter split over a model axis (parallel/tensor.py
    marks it `model_split`)."""
    m = torch.nn.Linear(2, 2)
    m.weight.model_split = object()
    return m


@pytest.mark.parametrize("case, change", [
    ("cpu", {"device": torch.device("cpu")}),
    ("autograd", {"training": True}),
    ("shard", {"shard": object()}),
    ("model_axis", {"model": _split_model()}),
    ("no_early_exit", {"early_exit": False}),
    ("sample", {"feedback": "sample"}),
    ("dropout", {"drop": object()}),
    ("spans", {}),
])
def test_engagement_picks_eager(case, change):
    assert graph_engages(**CARD)
    if case == "spans":
        with spans.on():
            assert not graph_engages(**CARD)
    else:
        assert not graph_engages(**{**CARD, **change})


def test_cpu_eval_runs_the_eager_loop():
    model, tables, cfg, world = _tiny("r2r")
    ep = _episodes(world, cfg, 4).to("cpu")
    spans.reset_counts()
    eval_fn = make_eval_fn(model, tables, cfg, "cpu")
    eval_fn(ep)
    n = spans.counts()
    assert n["rollout.steps"] == n["host_reads"] == eval_fn.steps
    assert "rollout.graph_replays" not in n
    assert "rollout.graph_captures" not in n


def test_hold_copies_into_one_buffer_a_name():
    g = StepGraph()
    a = torch.arange(4, dtype=torch.int32)
    buf = g.hold("x", a)
    assert torch.equal(buf, a) and buf.data_ptr() != a.data_ptr()
    assert g.hold("x", a + 10) is buf and torch.equal(buf, a + 10)
    assert g.hold("x", buf) is buf and torch.equal(buf, a + 10)
    # a dataclass of arrays field by field; an int passes; an alias of
    # another field's buffer gets a buffer of its own
    st = EnvState(node=buf, view_index=a, ended=a > 1, step=3,
                  path_nodes=a[None], path_len=a)
    held = g.hold("st", st)
    assert held.step == 3 and held.node is not buf
    assert held.node.data_ptr() != buf.data_ptr()
    assert {k for k in g.bufs if k.startswith("st.")} == {
        "st.node", "st.view_index", "st.ended", "st.path_nodes",
        "st.path_len"}
    assert g.hold("none", None) is None and "none" not in g.bufs
    obs = rd.envx.DuetObs(*(torch.ones(2) for _ in range(6)))
    assert g.hold("obs", obs).obj_img is None
    assert len([k for k in g.bufs if k.startswith("obs.")]) == 6


def test_held_counts_go_aside_until_added():
    spans.reset_counts()
    spans.count("a")
    with spans.held_counts() as held:
        spans.count("a", 2)
        spans.count("launches.attention_fwd", 3)
    assert spans.counts() == {"a": 1}
    assert dict(held) == {"a": 2, "launches.attention_fwd": 3}
    spans.add_counts(held)
    spans.add_counts(held)
    assert spans.counts() == {"a": 5, "launches.attention_fwd": 6}


def test_graphs_by_shape_and_dropped_when_a_parameter_changes():
    """One graph a shape of call; all dropped once a parameter is written
    in place (the modules' cached bf16 copies, which a graph reads, go
    stale) or moves."""
    model, tables, cfg, world = _tiny("r2r")
    graphs = StepGraphs(model)
    ep4, ep3 = (_episodes(world, cfg, b).to("cpu") for b in (4, 3))
    run4, run3 = (rd._run_of(model, tables, ep, cfg) for ep in (ep4, ep3))
    g4 = graphs.graph(run4, ep4)
    assert graphs.graph(run4, _episodes(world, cfg, 4, seed=9).to("cpu")) is g4
    assert graphs.graph(run3, ep3) is not g4
    assert graphs.graph(run4, ep4) is g4 and len(graphs.graphs) == 2
    model.load_state_dict(model.state_dict())  # in place, same addresses
    g4 = graphs.graph(run4, ep4)
    assert len(graphs.graphs) == 1 and graphs.graph(run4, ep4) is g4
    with torch.no_grad():
        next(model.parameters()).add_(1.0)  # an optimizer's update
    assert graphs.graph(run4, ep4) is not g4
    g4 = graphs.graph(run4, ep4)
    model.double()  # every parameter at a new address
    assert graphs.graph(run4, ep4) is not g4 and len(graphs.graphs) == 1


# ----------------------------------------------------------------- card
@pytest.fixture(scope="module", params=["r2r", "soon"])
def card(request):
    """A released-width DUET on the card: R2R's tables, or SOON's 100
    objects a node at 2,048-d; scan 0 has 5 nodes, scan 1 has 96."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph is captured on a card")
    if request.param == "r2r":
        cfg = duet_r2r_config()
        world = _world(cfg, small_nodes=5, large_nodes=96)
    else:
        cfg = soon_butd_config()
        world = _world(cfg, small_nodes=5, large_nodes=96, objects=100,
                       obj_dim=cfg.model.obj_feat_size)
    tr = DuetTrainer(cfg, world, device="cuda")
    eps = _episodes(world, cfg, 256, seed=11)
    scan = np.asarray(eps.scan)
    batches = {
        "small": _rows(eps, np.flatnonzero(scan == 0)[:8]),
        "large": _rows(eps, np.flatnonzero(scan == 1)[:8]),
        "mixed8": _rows(eps, np.arange(8)),
        "mixed64": _rows(eps, np.arange(64)),
    }
    yield tr.model, tr.tables, cfg, {k: v.to("cuda")
                                     for k, v in batches.items()}
    del tr
    gc.collect()
    torch.cuda.empty_cache()


def _eager(card, name):
    model, tables, cfg, batches = card
    return rollout_duet(model, tables, batches[name], cfg, early_exit=True)


def _assert_served(out, want, use_obj):
    assert torch.equal(out[0], want.path_nodes)
    assert torch.equal(out[1], want.path_len)
    if use_obj:
        assert torch.equal(out[2], want.pred_obj)
    for got, k in zip(out[-1], STOP_TABLE):
        assert torch.equal(got, getattr(want, k)), k


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ["mixed8", "mixed64"])
def test_graph_call_equals_eager_bit_for_bit(card, batch):
    model, tables, cfg, batches = card
    use_obj = tables.obj_feat is not None
    want = _eager(card, batch)
    eval_fn = make_eval_fn(model, tables, cfg, "cuda", detailed=True)
    for _ in range(2):  # the capture's call, then replays only
        _assert_served(eval_fn(batches[batch]), want, use_obj)
        assert eval_fn.steps == want.steps


@pytest.mark.cuda
def test_batches_that_end_at_different_steps(card):
    model, tables, cfg, batches = card
    use_obj = tables.obj_feat is not None
    eval_fn = make_eval_fn(model, tables, cfg, "cuda", detailed=True)
    steps = {}
    for name in ("large", "small", "mixed8", "mixed64", "small", "large"):
        want = _eager(card, name)
        _assert_served(eval_fn(batches[name]), want, use_obj)
        assert eval_fn.steps == want.steps
        steps[name] = eval_fn.steps
    assert steps["small"] <= 5 and len(set(steps.values())) > 1, steps


@pytest.mark.cuda
def test_weights_written_in_place_are_read(card):
    """After an in-place update of every parameter (as `load_state_dict`
    and the optimizers do) a call reads the new weights, not the bf16
    copies the first capture read."""
    model, tables, cfg, batches = card
    use_obj = tables.obj_feat is not None
    eval_fn = make_eval_fn(model, tables, cfg, "cuda", detailed=True)
    before = _eager(card, "mixed8")
    _assert_served(eval_fn(batches["mixed8"]), before, use_obj)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(-1.5)
        after = _eager(card, "mixed8")
        assert not torch.equal(after.stop_scores, before.stop_scores)
        _assert_served(eval_fn(batches["mixed8"]), after, use_obj)
    finally:
        model.load_state_dict(saved)
    _assert_served(eval_fn(batches["mixed8"]), before, use_obj)


@pytest.mark.cuda
def test_outputs_survive_the_next_call(card):
    model, tables, cfg, batches = card
    eval_fn = make_eval_fn(model, tables, cfg, "cuda", detailed=True)
    first = eval_fn(batches["large"])
    kept = [x.clone() for x in first[:-1]] + [[x.clone() for x in first[-1]]]
    eval_fn(batches["mixed8"])
    eval_fn(batches["large"])
    for x, y in zip(first[:-1], kept[:-1]):
        assert torch.equal(x, y)
    for x, y in zip(first[-1], kept[-1]):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_peak_memory_within_one_percent_of_eager(card):
    model, tables, cfg, batches = card

    def peak(call):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    # the eval stream's cuBLAS workspace, made once a process, on both
    # sides of the comparison
    make_eval_fn(model, tables, cfg, "cuda")(batches["mixed8"])
    eager = peak(lambda: _eager(card, "mixed64"))
    eval_fn = make_eval_fn(model, tables, cfg, "cuda")
    graph = peak(lambda: [eval_fn(batches["mixed64"]) for _ in range(2)])
    assert graph <= 1.01 * eager, (graph, eager)


@pytest.mark.cuda
def test_every_step_after_the_capture_is_a_replay(card):
    model, tables, cfg, batches = card
    ep = batches["mixed64"]
    eval_fn = make_eval_fn(model, tables, cfg, "cuda")
    spans.reset_counts()
    eval_fn(ep)  # one eager step, the capture, replays
    n = spans.counts()
    assert n["rollout.graph_captures"] == 2  # the start and the step
    assert n["rollout.graph_replays"] == n["rollout.steps"] - 1

    reset_launch_counts()
    _eager(card, "mixed64")
    eager_launches = launch_counts()
    spans.reset_counts()
    eval_fn(ep)
    n = spans.counts()
    assert n["rollout.graph_replays"] == n["rollout.steps"] == eval_fn.steps
    assert n["host_reads"] == n["rollout.steps"]
    assert "rollout.graph_captures" not in n
    assert launch_counts() == eager_launches

    spans.reset_counts()
    with spans.on():
        eval_fn(ep)
    spans.take()
    n = spans.counts()
    assert n["rollout.steps"] == eval_fn.steps
    assert "rollout.graph_replays" not in n
