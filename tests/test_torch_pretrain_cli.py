"""The port's pre-training CLI (`python -m vln_imagine_tpu_torch.scripts.
pretrain`) on the CPU:

- twins of tests/test_pretrain_cli.py's flag cases (task mix, task
  override, E2E flags) against the JAX script's parser;
- a synthetic feature run (`--steps 4 --log-steps 2 --valid-steps 2`):
  logs, validation lines, `model_step_2` / `model_step_4` snapshots;
- an E2E run on a made-up panorama bank with `--vit-init`: the snapshot's
  ViT is the timm file's; a file of another geometry stops with the
  shape-mismatch error;
- `--resume` continues from a snapshot to the budget;
- `--init-ckpt` (BERT layout) transfers leaves into the pre-training model;
- `--agent duet`: a synthetic run from an LXMERT file, its snapshot into
  DUET fine-tuning, the DUET preset (the JAX package's
  test_duet_preset_overrides); `--agent duet --e2e` exits; no CUDA and no
  `--device` exits; `--synthetic` takes the tiny preset off the card and
  the released one on it.
"""

import math
import os
import re
import sys

import numpy as np
import pytest
import torch

from vln_imagine_tpu_torch.models.vit import ViTConfig, VisionTransformer
from vln_imagine_tpu_torch.scripts import pretrain as cli
from vln_imagine_tpu_torch.train.trainer import init_params

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E = ["--e2e", "--batch-size", "2", "--tasks", "mlm", "sap", "mrc",
       "--image-prob-size", "8", "--image-size", "16", "--vit-patch", "8",
       "--vit-layers", "1", "--vit-hidden", "48", "--vit-heads", "4"]


def _jparse(argv, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    import pretrain as jcli

    monkeypatch.setattr(sys, "argv", ["pretrain.py"] + argv)
    return jcli.parse_args()


@pytest.mark.parametrize("argv", [
    ["--synthetic"],
    ["--synthetic", "--tasks", "mlm", "sap"],
    ["--raw-panorama-bank", "/data/panos.npy"],
    ["--e2e", "--synthetic", "--vit-hidden", "48"],
    ["--synthetic", "--grad-accum", "4", "--val-splits", "val_seen",
     "--mix-ratio", "2", "1", "1", "1", "1", "1", "--init-pretrained",
     "bert", "--no-prefetch"],
])
def test_flags_parse_as_the_jax_script(argv, monkeypatch):
    got, want = vars(cli.parse_args(argv)), vars(_jparse(argv, monkeypatch))
    assert {k: v for k, v in got.items() if k != "device"} == want
    assert got["device"] is None


def test_default_task_mix_and_overrides():
    args = cli.parse_args(["--synthetic"])
    assert args.agent == "hamt" and args.image_prob_size == 1000
    cfg = cli.config(args, torch.device("cpu"))
    assert cfg.pretrain.tasks == ("mlm", "sap", "sar", "sprel", "mrc", "itm")
    assert cfg.pretrain.mix_ratio == (5, 1, 1, 1, 2, 2)
    cfg = cli.config(cli.parse_args(["--synthetic", "--tasks", "mlm", "sap",
                                     "--grad-accum", "3"]),
                     torch.device("cpu"))
    assert cfg.pretrain.mix_ratio == (1, 1)
    assert cfg.pretrain.gradient_accumulation_steps == 3
    args = cli.parse_args(["--raw-panorama-bank", "/data/panos.npy"])
    assert not args.e2e  # main() derives it
    assert args.image_size == 224 and args.vit_layers == 12
    assert args.vit_hidden == 768 and args.vit_patch == 16


def test_synthetic_preset_is_tiny_off_the_card_and_released_on_it():
    args = cli.parse_args(["--synthetic", "--e2e"])
    tiny = cli.config(args, torch.device("cpu"))
    released = cli.config(args, torch.device("cuda"))
    assert tiny.model.hidden_size == 64
    assert released.model.hidden_size == 768
    assert released.model.num_l_layers == 9
    assert tiny.model.image_feat_size == released.model.image_feat_size == 768


def _losses(record):
    return [float(x) for x in re.findall(r"loss=([^\s,]+)", record)]


def test_synthetic_run(tmp_path):
    log = tmp_path / "pt"
    pt, state = cli.main(["--synthetic", "--steps", "4", "--log-steps", "2",
                          "--valid-steps", "2", "--batch-size", "4",
                          "--image-prob-size", "8", "--device", "cpu",
                          "--log-dir", str(log)])
    assert state.step == 4 and pt.optimizer.steps == 4
    for n in (2, 4):
        assert (log / f"model_step_{n}").exists()
        assert (log / f"train_state_{n}").exists()
    record = (log / "pretrain.txt").read_text()
    assert "valid @ step 2" in record and "valid @ step 4" in record
    losses = _losses(record)
    assert len(losses) == 12 and all(math.isfinite(x) for x in losses)
    sd = torch.load(log / "model_step_4", weights_only=True)
    assert sd.keys() == pt.model.state_dict().keys()


def _timm_file(path, image_size):
    vit = VisionTransformer(ViTConfig(image_size=image_size, patch_size=8,
                                      hidden_size=48, num_layers=1,
                                      num_heads=4, compute_dtype="float32"))
    init_params(vit, torch.Generator().manual_seed(image_size))
    sd = {**vit.state_dict(), "head.weight": torch.zeros(5, 48),
          "head.bias": torch.zeros(5)}
    torch.save({"model": sd}, path)
    return sd


def test_e2e_run_with_vit_init(tmp_path, capsys):
    sd = _timm_file(tmp_path / "vit.pth", 16)
    log = tmp_path / "e2e"
    pt, state = cli.main(["--synthetic", "--steps", "2", "--log-steps", "1",
                          "--valid-steps", "2", "--device", "cpu",
                          "--vit-init", str(tmp_path / "vit.pth"),
                          "--log-dir", str(log)] + E2E)
    assert "initialized ViT from" in capsys.readouterr().out
    assert state.step == 2
    record = (log / "pretrain.txt").read_text()
    assert "valid @ step 2" in record
    assert all(math.isfinite(x) for x in _losses(record))
    snap = torch.load(log / "model_step_2", weights_only=True)
    # a graft, not an init: the ViT holds the file's weights, moved by two
    # updates in the warm-up (lr 0, then 5e-5 / 10000)
    for k in ("pos_embed", "blocks.0.attn.qkv.weight"):
        np.testing.assert_allclose(snap[f"vit.{k}"].numpy(), sd[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
        assert np.abs(sd[k].numpy()).max() > 1e-3
    _timm_file(tmp_path / "vit32.pth", 32)
    with pytest.raises(ValueError, match="shape mismatch at pos_embed"):
        cli.main(["--synthetic", "--steps", "1", "--device", "cpu",
                  "--vit-init", str(tmp_path / "vit32.pth"),
                  "--log-dir", str(tmp_path / "bad")] + E2E)


def test_resume_continues_to_the_budget(tmp_path):
    base = ["--synthetic", "--log-steps", "1", "--valid-steps", "2",
            "--batch-size", "2", "--tasks", "mlm", "sap",
            "--image-prob-size", "8", "--device", "cpu"]
    a = tmp_path / "a"
    pt, _ = cli.main(base + ["--steps", "2", "--log-dir", str(a)])
    saved = {k: v.clone() for k, v in pt.model.state_dict().items()}
    b = tmp_path / "b"
    pt2, state = cli.main(base + ["--steps", "4", "--log-dir", str(b),
                                  "--resume", str(a / "model_step_2")])
    assert state.step == 4 and pt2.optimizer.steps == 4
    assert sorted(os.listdir(b)) == ["model_step_4", "pretrain.txt",
                                     "train_state_4"]
    assert "valid @ step 4" in (b / "pretrain.txt").read_text()
    assert any(not torch.equal(v, saved[k])
               for k, v in pt2.model.state_dict().items())


def test_init_ckpt_bert(tmp_path, capsys):
    from vln_imagine_tpu_torch.config import tiny_test_config
    from vln_imagine_tpu_torch.pretrain.hamt_model import HamtPretrainModel

    model = HamtPretrainModel(tiny_test_config("hamt").model,
                              image_prob_size=8)
    rng = np.random.default_rng(0)
    sd = {f"bert.{k}": torch.from_numpy(
        rng.standard_normal(v.shape).astype(np.float32))
        for k, v in model.state_dict().items()
        if k.startswith(("embeddings.", "encoder.layer."))}
    torch.save(sd, tmp_path / "bert.pth")
    pt, _ = cli.main(["--synthetic", "--steps", "1", "--valid-steps", "1",
                      "--batch-size", "2", "--tasks", "mlm",
                      "--image-prob-size", "8", "--device", "cpu",
                      "--init-ckpt", str(tmp_path / "bert.pth"),
                      "--log-dir", str(tmp_path / "run")])
    n = int(re.search(r"(\d+) leaves transferred",
                      capsys.readouterr().out).group(1))
    assert n == len(sd)


def test_duet_and_no_device_exit(monkeypatch, tmp_path, capsys):
    """`--agent duet` runs: a synthetic run on the CPU trains, validates
    each task and writes its snapshots, an LXMERT file initializes it, and
    the snapshot feeds DUET fine-tuning; `--e2e` stays HAMT's alone.  No
    CUDA and no `--device` exits."""
    from tests.test_pretrain_init import _embeddings, _lxrtx_layer
    from vln_imagine_tpu_torch.config import tiny_test_config
    from vln_imagine_tpu_torch.scripts import train as tcli

    m = tiny_test_config("duet").model
    rng = np.random.default_rng(0)
    sd = _embeddings(rng, "bert.embeddings", m.hidden_size, m.vocab_size,
                     m.max_position_embeddings)
    for i in range(m.num_x_layers):
        sd.update(_lxrtx_layer(rng, f"bert.encoder.x_layers.{i}",
                               m.hidden_size, m.intermediate_size))
    torch.save(sd, tmp_path / "model_LXRT.pth")
    log = tmp_path / "duet"
    pt, state = cli.main(["--agent", "duet", "--synthetic", "--steps", "2",
                          "--log-steps", "1", "--valid-steps", "2",
                          "--batch-size", "2", "--image-prob-size", "8",
                          "--device", "cpu", "--init-ckpt",
                          str(tmp_path / "model_LXRT.pth"),
                          "--init-pretrained", "lxmert", "--log-dir",
                          str(log)])
    n = int(re.search(r"from lxmert weights .*: (\d+) leaves transferred",
                      capsys.readouterr().out).group(1))
    assert n > 0 and state.step == 2
    assert pt.cfg.pretrain.tasks == ("mlm", "mrc", "sap")
    record = (log / "pretrain.txt").read_text()
    assert "valid @ step 2" in record
    losses = _losses(record)
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    d = tcli.main(["--agent", "duet", "--synthetic", "--iters", "1",
                   "--device", "cpu", "--init-from-pretrain",
                   str(log / "model_step_2"), "--log-dir",
                   str(tmp_path / "ft")])
    assert d.cfg.agent == "duet"
    assert re.search(r"\((\d+) leaves transferred",
                     capsys.readouterr().out)
    with pytest.raises(SystemExit, match="HAMT image pre-training"):
        cli.main(["--agent", "duet", "--synthetic", "--e2e", "--device",
                  "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["--synthetic", "--log-dir", str(tmp_path)])


def test_duet_preset_overrides():
    """`--agent duet` takes the DUET task mix (r2r_pretrain.json:43-50:
    mlm / mrc / sap 1:1:1, batch 64, 100,000 steps) on the released DUET
    preset, as the JAX script does; the CLI's flags override it."""
    on_card = cli.config(cli.parse_args(["--agent", "duet", "--synthetic"]),
                         torch.device("cuda"))
    assert on_card.agent == "duet" and on_card.model.hidden_size == 768
    assert on_card.model.num_x_layers == 4
    p = on_card.pretrain
    assert (p.tasks, p.mix_ratio, p.batch_size, p.num_train_steps) == (
        ("mlm", "mrc", "sap"), (1, 1, 1), 64, 100_000)
    over = cli.config(cli.parse_args(
        ["--agent", "duet", "--synthetic", "--tasks", "mlm", "og",
         "--batch-size", "8", "--steps", "10"]), torch.device("cpu"))
    assert over.model.hidden_size == 64
    p = over.pretrain
    assert (p.tasks, p.mix_ratio, p.batch_size, p.num_train_steps) == (
        ("mlm", "og"), (1, 1), 8, 10)
