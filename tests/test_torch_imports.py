"""The port stands alone: importing any of its modules pulls in neither JAX
nor the JAX package, and its entry points refuse to guess a device."""

import json
import os
import subprocess
import sys

import pytest
import torch

from vln_imagine_tpu_torch.config import tiny_test_config
from vln_imagine_tpu_torch.driver import FinetuneDriver, SplitData
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.models.hamt import HamtModel
from vln_imagine_tpu_torch.models.duet import DuetModel
from vln_imagine_tpu_torch.train import rollout_duet
from vln_imagine_tpu_torch.train.rollout_hamt import make_eval_fn
from vln_imagine_tpu_torch.train.trainer import HamtTrainer
from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import vln_imagine_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "optax", "orbax", "vln_imagine_tpu")
             or m.startswith(("jax.", "flax.", "optax.", "orbax.",
                              "vln_imagine_tpu.")))
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
                "envx.gmap", "models.bert", "models.hamt", "models.duet",
                "ckpt.convert", "train.rollout_hamt", "train.trainer",
                "train.rollout_duet", "train.trainer_duet", "eval.metrics",
                "utils.logger", "data.annotations", "data.features",
                "data.tokenizer", "data.nlp_tools", "eval.submission",
                "train.optim", "ckpt.manager", "ckpt.transfer", "driver",
                "scripts.train", "models.vit", "native", "pretrain.data",
                "pretrain.hamt_model", "pretrain.hamt_e2e", "pretrain.trainer",
                "scripts.pretrain", "scripts.extract_features",
                "pretrain.duet_data", "pretrain.duet_model",
                "data.lmdb_reader", "scripts.convert_lmdb_bank",
                "parallel", "parallel.distributed", "parallel.mesh"):
        assert f"vln_imagine_tpu_torch.{mod}" in report["modules"], mod


def test_entry_points_raise_without_device_or_cuda(monkeypatch, tmp_path):
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
    dcfg = tiny_test_config("duet")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DuetTrainer(dcfg, world)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rollout_duet.make_eval_fn(DuetModel(dcfg.model), world, dcfg)
    assert DuetTrainer(dcfg, world, device="cpu").device.type == "cpu"
    split = SplitData("train", synthetic_episodes(world, batch=2, seed=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FinetuneDriver(cfg, world, split, [], str(tmp_path))
    assert FinetuneDriver(cfg, world, split, [], str(tmp_path),
                          device="cpu").device.type == "cpu"
    from vln_imagine_tpu_torch.models.vit import (
        FeatureExtractor,
        ViTConfig,
        VisionTransformer,
    )
    from vln_imagine_tpu_torch.pretrain.trainer import HamtPretrainer
    vit = VisionTransformer(ViTConfig(image_size=16, patch_size=8,
                                      hidden_size=32, num_layers=1,
                                      num_heads=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FeatureExtractor(vit)
    assert FeatureExtractor(vit, device="cpu").device.type == "cpu"
    ep = synthetic_episodes(world, batch=2, max_gt_path_len=6, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HamtPretrainer(cfg, world, ep, image_prob_size=8)
    assert HamtPretrainer(cfg, world, ep, image_prob_size=8,
                          device="cpu").device.type == "cpu"

