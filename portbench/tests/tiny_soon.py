"""A benchmark root with one tiny DUET cell whose nodes hold objects wider
than the views (`portbench/agents/duet_obj.py`), for CPU tests."""

from __future__ import annotations

import json
from pathlib import Path

from portbench.tests.tiny import make_root

OBJ_DIM = 48  # the tiny views are 32 wide
SLOTS = 6
# float32 at the tiny widths, where a sound program reads 0
LIMITS = {"mean_logit_gap": 1e-4, "mean_stop_logit_gap": 1e-4,
          "path_mismatch": 0, "mean_og_logit_gap": 1e-4, "invalid_objects": 0}
PRESET = "tiny_soon_config"


def tiny_soon_config(obj_dim: int = OBJ_DIM):
    """The port's tiny DUET preset with objects `obj_dim` wide (SOON's case
    where it differs from the views' 32, REVERIE's where not) and one
    imagination."""
    from vln_imagine_tpu_torch.config import _replace, tiny_test_config

    return _replace(tiny_test_config("duet"), "model", obj_feat_size=obj_dim,
                    max_imagination_len=1)


def make_soon_root(tmp: Path, monkeypatch, limits: dict | None = LIMITS,
                   batch: int = 4, split: int = 8, obj_dim: int = OBJ_DIM) -> Path:
    """make_root's tiny DUET cell with objects: its configuration names
    `tiny_soon_config`, which `monkeypatch` lends the port's config module."""
    from vln_imagine_tpu_torch import config as port_config

    monkeypatch.setattr(port_config, PRESET, tiny_soon_config, raising=False)
    root = make_root(tmp, agent="duet", batch=batch, split=split, limits=limits)
    pb = root / "portbench"
    cfg_path = pb / "configs" / "tiny.json"
    cfg = json.loads(cfg_path.read_text())
    cfg.update(agent="duet_obj", preset=PRESET, preset_args=[obj_dim],
               max_objects=SLOTS)
    cfg["model"].update(obj_feat_size=obj_dim, max_imagination_len=1)
    cfg_path.write_text(json.dumps(cfg))
    traffic_path = pb / "traffic" / "eval_tiny.json"
    traffic = json.loads(traffic_path.read_text())
    traffic["objects"] = {"valid": [2, SLOTS]}
    traffic_path.write_text(json.dumps(traffic))
    return root
