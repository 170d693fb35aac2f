"""The port stands alone: importing any of its modules pulls in neither JAX
nor the JAX package, and its entry points refuse to guess a device."""

import json
import os
import subprocess
import sys

import pytest
import torch

from vln_imagine_tpu_torch.config import tiny_test_config
from vln_imagine_tpu_torch.envx import synthetic_world
from vln_imagine_tpu_torch.models.hamt import HamtModel
from vln_imagine_tpu_torch.train.rollout_hamt import make_eval_fn
from vln_imagine_tpu_torch.train.trainer import HamtTrainer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import vln_imagine_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "optax", "vln_imagine_tpu")
             or m.startswith(("jax.", "flax.", "optax.", "vln_imagine_tpu.")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    # every module of the slice was imported
    for mod in ("config", "platform", "ops.attention", "ops.masks", "ops.angles",
                "envx.tables", "envx.compiler", "envx.synthetic", "envx.env",
                "models.bert", "models.hamt", "ckpt.convert",
                "train.rollout_hamt", "train.trainer", "eval.metrics"):
        assert f"vln_imagine_tpu_torch.{mod}" in report["modules"], mod


def test_entry_points_raise_without_device_or_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config("hamt")
    world, _ = synthetic_world(num_scans=1, num_nodes=6,
                               max_candidates=cfg.env.max_candidates,
                               views=cfg.env.views,
                               feat_dim=cfg.model.image_feat_size, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HamtTrainer(cfg, world)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_fn(HamtModel(cfg.model), world, cfg)
    assert HamtTrainer(cfg, world, device="cpu").device.type == "cpu"

