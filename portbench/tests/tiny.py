"""A benchmark root at the tiny test widths, for CPU tests of the harness."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]

MODEL_KEYS = ("vocab_size", "hidden_size", "num_attention_heads",
              "intermediate_size", "max_position_embeddings", "type_vocab_size",
              "hidden_act", "num_l_layers", "num_x_layers", "num_pano_layers",
              "image_feat_size", "angle_feat_size", "obj_feat_size",
              "max_action_steps", "max_imagination_len", "compute_dtype")
ENV_KEYS = ("views", "max_candidates", "max_action_len", "max_instr_len",
            "max_gt_path_len", "max_gmap_nodes")
# the numbers each agent's cells compare, at limits for float32 at the
# tiny widths, where a sound program reads 0
LIMITS = {"hamt": {"logit_gap": 1e-3},
          "duet": {"mean_logit_gap": 1e-4, "mean_stop_logit_gap": 1e-4,
                   "path_mismatch": 0}}


def tiny_config(agent: str) -> dict:
    """A configuration file of the port's tiny test preset."""
    from vln_imagine_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config(agent)
    return {"name": "tiny", "agent": agent, "preset": "tiny_test_config",
            "preset_args": [agent], "weights_seed": 5,
            "model": {k: getattr(cfg.model, k) for k in MODEL_KEYS},
            "env": {k: getattr(cfg.env, k) for k in ENV_KEYS}}


def make_root(tmp: Path, agent: str = "hamt", batch: int = 4, split: int = 8,
              limits: dict | None = None) -> Path:
    """tmp/BENCHMARK.json with one tiny eval cell, and tmp/portbench/ with
    the real metrics, kernels and peaks beside the tiny data files."""
    pb = tmp / "portbench"
    for sub in ("metrics", "kernels"):
        shutil.copytree(PORTBENCH / sub, pb / sub)
    shutil.copy(PORTBENCH / "peaks.json", pb / "peaks.json")
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    (pb / "configs" / "tiny.json").write_text(json.dumps(tiny_config(agent)))
    traffic = {"cell": "EvalCell", "kind": "eval", "batch": batch,
               "split": split, "scans": 2, "nodes_per_scan": 20,
               "warmup_calls": 1, "trace_calls": 2, "check_items": 64,
               "instructions": json.loads((PORTBENCH / "traffic" / "eval_b512.json")
                                          .read_text())["instructions"]}
    (pb / "traffic" / "eval_tiny.json").write_text(json.dumps(traffic))
    if limits is not None:
        (pb / "limits" / "tiny.eval_tiny.json").write_text(json.dumps(limits))
    real = json.loads((PORTBENCH.parent / "BENCHMARK.json").read_text())
    wl = "tiny.eval_tiny"
    bench = {
        "configs": [{"name": "tiny", "file": "portbench/configs/tiny.json"}],
        "workloads": [{"name": wl, "config": "tiny", "traffic": "eval_tiny",
                       "chips": 1}],
        "end_to_end": [dict(m, workloads=[wl]) for m in real["end_to_end"]
                       if m["name"] in ("eval_episodes_per_s", "peak_mem_gb",
                                        "setup_s")],
        "per_layer": [dict(m, workloads=[wl]) for m in real["per_layer"]
                      if m["name"].endswith(".eval")],
    }
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
