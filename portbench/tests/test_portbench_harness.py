"""The harness on the CPU: what it finds by name, the window's arithmetic,
the census against hand counts, and the last line."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from portbench.reference import duet as duet_ref
from portbench.reference import hamt as hamt_ref
from portbench.registry import Registry
from portbench.run import run_cell
from portbench.tests.tiny import LIMITS, make_root
from portbench.window import run_window

REPO = Path(__file__).resolve().parents[2]


def test_files_added_alone_are_found(tmp_path):
    root = make_root(tmp_path)
    pb = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    # a configuration, a traffic mix, a metric and a kernel family, as files
    (pb / "configs" / "other.json").write_text(json.dumps({"agent": "hamt", "x": 1}))
    bench["configs"].append({"name": "other", "file": "portbench/configs/other.json"})
    (pb / "traffic" / "burst.json").write_text(json.dumps({"kind": "eval", "batch": 3}))
    bench["workloads"].append({"name": "other.burst", "config": "other",
                               "traffic": "burst", "chips": 1})
    (pb / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return ctx.work / ctx.window_s\n")
    bench["per_layer"].append({"name": "calls_per_s.eval", "unit": "1/s",
                               "workloads": ["other.burst"]})
    (pb / "kernels" / "attention" / "sdpa.json").write_text(
        json.dumps({"patterns": ["flash_fwd"]}))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    reg = Registry(root)
    assert reg.config("other")["x"] == 1
    assert reg.traffic("burst")["batch"] == 3
    names = [m["name"] for m in reg.metrics("other.burst", "per_layer")]
    assert names == ["calls_per_s.eval"]
    assert "calls_per_s.eval" not in [
        m["name"] for m in reg.metrics("tiny.eval_tiny", "per_layer")]
    # a dotted name falls back to the reader of its base name
    ctx = type("Ctx", (), {"work": 6, "window_s": 2.0})
    assert reg.reader("calls_per_s.eval")(ctx) == 3.0
    pats = reg.kernel_patterns("attention")
    assert "flash_fwd" in pats and "attention_fwd_kernel" in pats


class FakeClock:
    def __init__(self, durations):
        self.t, self.durations = 0.0, list(durations)

    def __call__(self):
        return self.t

    def call(self, i):
        self.t += self.durations[i]
        return i


def test_window_counts_completed_calls_and_stalls():
    # 1 s calls with a 3 s stall, in a 5 s window: calls 0-2 end at 1, 4, 5
    clock = FakeClock([1.0, 3.0, 1.0, 1.0, 1.0])
    done, elapsed = run_window(clock.call, 5.0, clock=clock)
    assert [i for i, _ in done] == [0, 1, 2] and elapsed == 5.0
    # the call running past the end is neither counted nor timed
    clock = FakeClock([2.0, 2.0, 2.0, 2.0])
    done, elapsed = run_window(clock.call, 5.0, clock=clock)
    assert len(done) == 2 and elapsed == 4.0
    # a window shorter than one call still measures that call
    clock = FakeClock([3.0, 3.0])
    done, elapsed = run_window(clock.call, 1.0, clock=clock)
    assert len(done) == 1 and elapsed == 3.0


def test_instruction_sizes_follow_the_published_means_and_caps():
    from portbench import worldgen

    instr = Registry(REPO).traffic("eval_b512")["instructions"]
    tokens, subs = worldgen.instruction_sizes(instr, 4096, 200, 20)
    words = (tokens - instr["special_tokens"]) / instr["tokens_per_word"]
    assert abs(words.mean() / instr["words_mean"] - 1) < 0.05
    assert abs(subs.mean() / instr["sub_instructions_mean"] - 1) < 0.05
    assert tokens.max() < 200 and subs.min() >= 1
    # the cap cuts as the program's max_instr_len does
    capped, capped_subs = worldgen.instruction_sizes(instr, 4096, 60, 20)
    assert capped.max() == 60 and (capped == np.minimum(tokens, 60)).all()
    assert (capped_subs < capped).all()
    # every seed gets the same sizes, in its own order
    _, paths = worldgen.scan_graphs(3, 2, 20)
    eps = [worldgen.episodes(seed, paths, 20, 64, 8, 60, 20, 100, instr)
           for seed in (1, 2 ** 40 + 1)]
    lens = [e["txt_mask"].sum(1) for e in eps]
    assert sorted(lens[0]) == sorted(lens[1]) and (lens[0] != lens[1]).any()


def test_flop_and_byte_counters_against_hand_counts():
    H, F_, L = 4, 8, 3
    # q, k, v (3 H x H), scores and context (2 x L x L x H), output, FFN
    hand = 2 * (3 * L * H * H + L * L * H + L * L * H + L * H * H + 2 * L * H * F_)
    assert hamt_ref.bert_layer_flops(L, H, F_) == hand
    assert hamt_ref.cross_flops(2, 5, H) == 2 * (2 * H * H + 2 * 5 * H * H
                                                + 2 * 2 * 5 * H + 2 * H * H)
    assert hamt_ref.attn_bytes(2, 5, H) == (2 * 2 * H + 2 * 5 * H) * 2 + 4 * 5

    m = {"hidden_size": H, "intermediate_size": F_, "image_feat_size": 6,
         "angle_feat_size": 4, "num_l_layers": 1, "num_x_layers": 1,
         "num_pano_layers": 1}
    V = 2
    # one HAMT episode: text 3, one imagination with a noun phrase, one step
    # over 4 observation tokens, 2 of them navigable; no history token read
    flops, nbytes = hamt_ref.census(m, V, [3], [1], [1], [1],
                                    np.array([[4.0]]), np.array([[2.0]]))
    Ll, Lv = 4, 1 + 4
    hand = (hamt_ref.bert_layer_flops(3, H, F_)
            + 2 * (H * 512 + 512 * 512 + 512 * H) + 2 * 3 * H
            + 2 * 4 * (6 + 4) * H
            + hamt_ref.cross_flops(Ll, Lv, H) + hamt_ref.cross_flops(Lv, Ll, H)
            + hamt_ref.bert_layer_flops(Ll, H, F_) + hamt_ref.bert_layer_flops(Lv, H, F_)
            + 2 * 2 * (H * H + H))
    assert flops == hand
    ab = hamt_ref.attn_bytes
    assert nbytes == ab(3, 3, H) + ab(Ll, Lv, H) + ab(Lv, Ll, H) + ab(Ll, Ll, H) + ab(Lv, Lv, H)
    # a second step reads one history token: its pano encoder over V views
    f2, b2 = hamt_ref.census(m, V, [3], [1], [1], [2],
                             np.array([[4.0, 4.0]]), np.array([[2.0, 2.0]]))
    Lv2 = 2 + 4
    step2 = (2 * 4 * (6 + 4) * H + hamt_ref.cross_flops(Ll, Lv2, H)
             + hamt_ref.cross_flops(Lv2, Ll, H) + hamt_ref.bert_layer_flops(Ll, H, F_)
             + hamt_ref.bert_layer_flops(Lv2, H, F_) + 2 * 2 * (H * H + H))
    hist = 2 * (6 + 4) * H * (1 + V) + hamt_ref.bert_layer_flops(V, H, F_)
    assert f2 == hand + step2 + hist
    assert b2 == nbytes + ab(Ll, Lv2, H) + ab(Lv2, Ll, H) + ab(Ll, Ll, H) + ab(Lv2, Lv2, H) + ab(V, V, H)

    # one DUET step: 5 panorama tokens, 2 candidates, 3 map nodes
    fd, bd = duet_ref.census(m, [3], [1], [1], [[(5.0, 2.0, 3.0)]])
    gl, vl = 4, 6
    hand_d = (hamt_ref.bert_layer_flops(3, H, F_)
              + 2 * (H * 512 + 512 * 512 + 512 * H) + 2 * 3 * H
              + 2 * 5 * (6 + 7) * H + hamt_ref.bert_layer_flops(5, H, F_)
              + 2 * gl * 7 * H + 2 * vl * 14 * H
              + hamt_ref.cross_flops(gl, Ll, H) + hamt_ref.bert_layer_flops(gl, H, F_)
              + hamt_ref.cross_flops(vl, Ll, H) + hamt_ref.bert_layer_flops(vl, H, F_)
              + 2 * (gl + 3) * (H * H + H) + 4 * H * H)
    assert fd == hand_d
    assert bd == (ab(3, 3, H) + ab(5, 5, H) + ab(gl, Ll, H) + ab(gl, gl, H)
                  + 4 * gl * gl + ab(vl, Ll, H) + ab(vl, vl, H))


@pytest.mark.parametrize("agent", ["hamt", "duet"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_has_the_contract_keys(tmp_path, agent, trace):
    root = make_root(tmp_path, agent=agent, limits=LIMITS[agent])
    r = run_cell(root, "tiny.eval_tiny", 2 ** 31 + 11, 0.3, trace, device="cpu",
                 t_start=time.perf_counter())
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "compared"
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] % 4 == 0 and r["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    for c in r["compared"].values():
        assert c["value"] <= c["limit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r
        # the CPU has no device trace: the device metrics find nothing
        assert r["metrics"] == {}
    else:
        assert set(r["metrics"]) == {"eval_episodes_per_s", "peak_mem_gb", "setup_s"}
        assert all(v["value"] > 0 for k, v in r["metrics"].items()
                   if k != "peak_mem_gb")


def test_a_machine_without_a_card_gets_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "hamt_r2r.eval_b512",
         "--seed", "1", "--seconds", "1"], cwd=REPO, capture_output=True,
        text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                                     "HOME": str(tmp_path)})
    assert out.returncode == 3 and out.stdout == ""
    assert "CUDA card" in out.stderr


_PROBE = r"""
import importlib, json, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "vln_imagine_tpu"}


def _top_level(*modules):
    out = subprocess.run([sys.executable, "-c", _PROBE, *modules], cwd=REPO,
                         capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_imports_neither_jax_nor_the_jax_package():
    loaded = _top_level("portbench.run", "portbench.registry", "portbench.trace",
                        "portbench.calibrate", "portbench.agents.hamt",
                        "portbench.agents.duet",
                        "vln_imagine_tpu_torch.train.trainer",
                        "vln_imagine_tpu_torch.train.trainer_duet")
    assert not loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    loaded = _top_level("portbench.reference.common", "portbench.reference.world",
                        "portbench.reference.gmap", "portbench.reference.hamt",
                        "portbench.reference.duet", "portbench.worldgen")
    assert not loaded & (FORBIDDEN | {"vln_imagine_tpu_torch"})


def test_trace_reduction_on_hand_made_events():
    from portbench.trace import Trace

    device = [(0, 10, "gemm"), (5, 15, "attention_fwd_kernel<bf16>"),
              (20, 30, "gemm"), (40, 41, "copy")]
    host = [(0, 50, "eval_step"), (14, 22, "aten::index"), (30, 45, "aten::cat")]
    tr = Trace(device, host)
    assert tr.busy_ns == 26  # [0, 15) + [20, 30) + [40, 41)
    assert tr.kernel_ns(["attention_fwd_kernel"]) == 10
    assert tr.top_ops(2) == [["gemm", 20e-9], ["attention_fwd_kernel<bf16>", 10e-9]]
    # the gaps, longest first, named by the innermost host op at their middle
    assert tr.idle_gaps() == [["aten::cat", 10e-9], ["aten::index", 5e-9]]
