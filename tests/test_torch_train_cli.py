"""The port's train CLI (`python -m vln_imagine_tpu_torch.scripts.train`) on
the CPU:

- twins of tests/test_train_cli.py (flag -> config wiring and its guards);
- every flag whose branch is not ported exits naming its ROADMAP item, and
  a run with no CUDA and no `--device` exits; `--synthetic` takes the tiny
  preset off the card and the released one on it;
- a `--synthetic --iters 2 --log-every 1 --device cpu` run of each agent,
  and a one-step run (or an `--eval-only --submit` pass) under each flag of
  the deferred training branches: `--detailed-output` writes
  `detail_<split>.json`, `--expl-sample`, `--act-visited-nodes` and
  `--aux-loss-type infonce` / `margin` reach the config and train;
- `build_real` on a schema-exact artefact set written here (MP3D
  connectivity JSON, `R2R_<split>_enc.json`, HDF5 view and imagination
  features, generated-flag and sub-instruction JSON) gives the same
  WorldTables and EpisodeBatch arrays as scripts/train.py's, exactly; then
  `--eval-only --submit --init-from-reference` on it, with the released
  preset patched to the tiny one and a released-format agent save written
  from the port's own tiny model.
"""

import json
import math
import os
import re
import sys

import h5py
import numpy as np
import pytest
import torch

from vln_imagine_tpu_torch import config as C
from vln_imagine_tpu_torch.config import _replace, tiny_test_config
from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
from vln_imagine_tpu_torch.scripts import train as cli
from vln_imagine_tpu_torch.train.trainer import HamtTrainer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pretrain_snapshot(log_dir, step: int) -> str:
    """A `model_step_<step>` of the port's HAMT pre-trainer at the tiny
    config, untrained."""
    from vln_imagine_tpu_torch.pretrain.trainer import (
        HamtPretrainer,
        PretrainState,
    )

    cfg = tiny_test_config("hamt")
    world, _ = synthetic_world(num_scans=1, num_nodes=12,
                               max_candidates=cfg.env.max_candidates,
                               views=cfg.env.views,
                               feat_dim=cfg.model.image_feat_size, seed=0)
    ep = synthetic_episodes(world, batch=2,
                            max_gt_path_len=cfg.env.max_gt_path_len,
                            max_instr_len=cfg.env.max_instr_len,
                            max_imaginations=cfg.model.max_imagination_len,
                            vocab_size=cfg.model.vocab_size,
                            feat_dim=cfg.model.hidden_size, seed=1)
    pt = HamtPretrainer(cfg, world, ep, image_prob_size=8, device="cpu")
    os.makedirs(log_dir, exist_ok=True)
    return pt.save(PretrainState(step), str(log_dir))


# ------------------------------------------------------ twins of test_train_cli
def test_no_lang_ca_flag():
    assert cli.parse_args(["--synthetic", "--no-lang-ca"]).no_lang_ca is True
    assert cli.parse_args(["--synthetic"]).no_lang_ca is False


def test_fix_lang_embedding_tristate():
    # None = keep the preset's value; explicit flags override either way
    assert cli.parse_args(["--synthetic"]).fix_lang_embedding is None
    assert cli.parse_args(["--synthetic", "--fix-lang-embedding"]
                          ).fix_lang_embedding is True
    assert cli.parse_args(["--synthetic", "--train-lang-embedding"]
                          ).fix_lang_embedding is False


def test_overrides_reach_model_config():
    args = cli.parse_args(["--synthetic", "--no-lang-ca", "--no-imagination",
                           "--train-lang-embedding"])
    cfg = tiny_test_config(args.agent)
    cfg = _replace(cfg, "model", **cli.model_overrides(args, cfg))
    assert cfg.model.no_lang_ca is True
    assert cfg.model.fix_lang_embedding is False
    assert cfg.model.imagine_enc_pano is False


def test_no_lang_ca_guards():
    args = cli.parse_args(["--synthetic", "--no-lang-ca"])
    with pytest.raises(SystemExit, match="imagination|aux"):
        cli.model_overrides(args, tiny_test_config("hamt"))
    args = cli.parse_args(["--agent", "duet", "--synthetic", "--no-lang-ca"])
    with pytest.raises(SystemExit, match="HAMT"):
        cli.model_overrides(args, tiny_test_config("duet"))


# --------------------------------------------------------------- refusals
@pytest.mark.parametrize("flags, item", [
    (["--mesh-data", "2"], 7),
    (["--e2e-imagination", "frozen"], 5),
    (["--init-from-pretrain", "model_step_10"], 6),
    (["--obj-features", "obj.hdf5"], 4),
    (["--dataset", "cvdn"], 4),
])
def test_unported_flags_exit_naming_their_item(flags, item, tmp_path, capsys):
    """Item 7 exits, naming its ROADMAP item.  Items 4-6 are ported: their
    flags, once refused here, now run (the synthetic world has no object
    store, so `--obj-features` is not read; `--e2e-imagination` gives the
    synthetic episodes raw images; `--init-from-pretrain` reads a snapshot
    of the port's pre-trainer written here)."""
    argv = ["--synthetic", "--device", "cpu"] + flags
    if item == 6:
        argv[-1] = _pretrain_snapshot(tmp_path / "pretrain", step=10)
    if item in (4, 5, 6):
        d = cli.main(argv + ["--iters", "1", "--log-every", "1",
                             "--log-dir", str(tmp_path)])
        assert d.cfg.dataset == (flags[1] if flags[0] == "--dataset"
                                 else "r2r")
        assert os.path.exists(tmp_path / "ckpts" / "latest_dict")
        if item == 5:
            assert d.cfg.model.e2e_imagination == "frozen"
            assert hasattr(d.trainer.model, "imagine_vit")
        if item == 6:
            n = int(re.search(r"\((\d+) leaves transferred",
                              capsys.readouterr().out).group(1))
            assert n > 0
        return
    with pytest.raises(SystemExit, match=f"ROADMAP Queue 1 item {item}$"):
        cli.main(argv)


@pytest.mark.parametrize("flags, part, key, value", [
    (["--agent", "duet", "--detailed-output", "--eval-only", "--submit"],
     "train", "detailed_output", True),
    (["--agent", "duet", "--expl-sample"], "train", "expl_sample", True),
    (["--agent", "duet", "--act-visited-nodes"], "train", "act_visited_nodes",
     True),
    (["--aux-loss-type", "infonce"], "model", "aux_loss_type", "infonce"),
    (["--aux-loss-type", "margin"], "model", "aux_loss_type", "margin"),
    (["--act-pred-token", "ob_imagine_text"], "model", "act_pred_token",
     "ob_imagine_text"),
])
def test_deferred_branch_flags_run(tmp_path, flags, part, key, value):
    d = cli.main(["--synthetic", "--iters", "1", "--log-every", "1",
                  "--device", "cpu", "--log-dir", str(tmp_path)] + flags)
    assert getattr(getattr(d.cfg, part), key) == value
    if "--eval-only" in flags:  # the stop table of every validated item
        for split in d.val_splits:
            preds = json.loads((tmp_path / f"detail_{split.name}.json")
                               .read_text())
            assert len(preds) == split.episodes.scan.shape[0]
            for p in preds:
                vps = [vp for vp, *_ in p["trajectory"]]
                assert {vps[0], vps[-1]} <= p["details"].keys() <= set(vps)
                assert all(0.0 <= v["stop_prob"] <= 1.0
                           for v in p["details"].values())
        return
    assert d.trainer.optimizer.steps == 1
    lines = (tmp_path / "train.txt").read_text()
    assert "iter 1" in lines and "nan" not in lines.lower()


def test_no_cuda_and_no_device_exits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--synthetic"])


@pytest.mark.parametrize("agent", ["hamt", "duet"])
def test_synthetic_preset_is_tiny_off_the_card_and_released_on_it(agent):
    args = cli.parse_args(["--agent", agent, "--synthetic"])
    assert cli.preset(args, torch.device("cpu")) == tiny_test_config(agent)
    released = (C.hamt_r2r_config() if agent == "hamt"
                else C.duet_r2r_config())
    assert cli.preset(args, torch.device("cuda")) == released
    assert cli.preset(cli.parse_args(["--agent", agent]),
                      torch.device("cpu")) == released


@pytest.mark.parametrize("agent", ["hamt", "duet"])
def test_synthetic_run_on_the_cpu(tmp_path, agent):
    d = cli.main(["--agent", agent, "--synthetic", "--iters", "2",
                  "--log-every", "1", "--device", "cpu", "--aug", "x",
                  "--log-dir", str(tmp_path)])
    assert d.device.type == "cpu" and d.trainer.optimizer.steps == 2
    assert d.aug_split is not None
    for name in ("train.txt", "metrics.jsonl", "ckpts/latest_dict",
                 "ckpts/best_val_unseen"):
        assert os.path.isfile(tmp_path / name), name
    lines = (tmp_path / "train.txt").read_text().splitlines()
    assert [ln.split("]")[1].split(",")[0] for ln in lines] == \
        [" iter 1", " iter 2"]


# ------------------------------------------------------- real-data artefacts
N_TRAIN, N_VAL = 4, 6


def _write_connectivity(graphs, out_dir):
    """ScanGraph -> `<scan>_connectivity.json` in the MP3D schema the
    compiler parses (image_id, included, 4x4 pose with xyz at 3/7/11,
    unobstructed adjacency row), with one excluded viewpoint per scan."""
    os.makedirs(out_dir, exist_ok=True)
    for g in graphs:
        n = g.num_nodes
        unob = [[False] * (n + 1) for _ in range(n + 1)]
        for a, b in g.edges:
            unob[a][b] = unob[b][a] = True
        items = []
        for i, vid in enumerate(g.node_ids + [g.scan_id + "_excluded"]):
            pose = [0.0] * 16
            pose[0] = pose[5] = pose[10] = pose[15] = 1.0
            if i < n:
                pose[3], pose[7], pose[11] = map(float, g.xyz[i])
            items.append({"image_id": vid, "pose": pose, "included": i < n,
                          "unobstructed": unob[i], "height": 1.5})
        with open(os.path.join(out_dir,
                               f"{g.scan_id}_connectivity.json"), "w") as f:
            json.dump(items, f)


def _write_annotations(graphs, ep, rows, anno_dir, split, path_id0):
    """EpisodeBatch rows -> R2R_<split>_enc.json items, two instructions a
    path."""
    items = []
    for j, b in enumerate(rows):
        g = graphs[int(ep.scan[b])]
        path = [g.node_ids[int(v)] for v in ep.gt_path[b, :int(ep.gt_len[b])]]
        enc = [int(t) for t in ep.txt_ids[b][ep.txt_mask[b]]]
        items.append({
            "distance": float(int(ep.gt_len[b]) - 1) * 2.2,
            "scan": g.scan_id, "path_id": path_id0 + j, "path": path,
            "heading": float(ep.start_heading[b]),
            "instructions": ["walk along the corridor and stop.",
                             "go ahead, then stop."],
            "instr_encodings": [enc, enc[::-1]],
        })
    os.makedirs(anno_dir, exist_ok=True)
    with open(os.path.join(anno_dir, f"R2R_{split}_enc.json"), "w") as f:
        json.dump(items, f)
    return [f"{it['path_id']}_{k}" for it in items for k in range(2)]


def _write_features(graphs, path, views, dim, rng):
    with h5py.File(path, "w") as f:
        for g in graphs:
            for vid in g.node_ids:
                f.create_dataset(f"{g.scan_id}_{vid}", data=(
                    rng.standard_normal((views, dim)) * 0.4).astype(np.float32))


def _write_imagination(instr_ids, imag_file, flag_file, sub_file, dim, rng):
    """v2 imagination features, generated flags (one sub-instruction in
    four not generated) and sub-instruction / noun-phrase metadata."""
    flags, subs = {}, []
    with h5py.File(imag_file, "w") as f:
        for iid in instr_ids:
            n = int(rng.integers(1, 4))
            flags[iid] = ["True" if rng.random() < 0.75 else "False"
                          for _ in range(n)]
            f.create_dataset(iid, data=(rng.standard_normal(
                (flags[iid].count("True"), dim)) * 0.4).astype(np.float32))
            subs.append({"instruction_id": iid,
                         "instr_segmentation_indices": [[1, 4]] * n,
                         "noun_phrase_indices": [[[2, 3]]] * n})
    with open(flag_file, "w") as f:
        json.dump(flags, f)
    with open(sub_file, "w") as f:
        json.dump(subs, f)


@pytest.fixture(scope="module")
def artefacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("artefacts")
    cfg = tiny_test_config("hamt")
    world, graphs = synthetic_world(
        num_scans=2, num_nodes=12, max_candidates=cfg.env.max_candidates,
        views=cfg.env.views, feat_dim=cfg.model.image_feat_size, seed=0,
        with_features=False)
    ep = synthetic_episodes(
        world, batch=N_TRAIN + N_VAL, max_gt_path_len=cfg.env.max_gt_path_len,
        max_instr_len=cfg.env.max_instr_len, max_imaginations=3,
        vocab_size=cfg.model.vocab_size, feat_dim=cfg.model.hidden_size,
        seed=1)
    rng = np.random.default_rng(2)
    paths = {k: str(root / v) for k, v in (
        ("conn", "connectivity"), ("anno", "annotations"),
        ("feat", "vit_features.hdf5"), ("imag", "imagine.hdf5"),
        ("flags", "generated_flags.json"), ("sub", "sub_instr.json"))}
    _write_connectivity(graphs, paths["conn"])
    ids = _write_annotations(graphs, ep, range(N_TRAIN), paths["anno"],
                             "train", 0)
    val_ids = _write_annotations(graphs, ep, range(N_TRAIN, N_TRAIN + N_VAL),
                                 paths["anno"], "val_unseen", 100)
    _write_features(graphs, paths["feat"], cfg.env.views,
                    cfg.model.image_feat_size, rng)
    _write_imagination(ids + val_ids, paths["imag"], paths["flags"],
                       paths["sub"], cfg.model.hidden_size, rng)
    argv = ["--connectivity-dir", paths["conn"], "--anno-dir", paths["anno"],
            "--img-features", paths["feat"], "--imagine-features",
            paths["imag"], "--generated-flag-file", paths["flags"],
            "--sub-instr-file", paths["sub"], "--splits", "train",
            "val_unseen"]
    return {"root": root, "argv": argv, "graphs": graphs, "val_ids": val_ids,
            "anno": paths["anno"]}


def _fields(x):
    import dataclasses
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def _assert_arrays_equal(got, want):
    g, w = _fields(got), _fields(want)
    for name, value in w.items():
        if value is None:
            assert g.get(name) is None, name
            continue
        a, b = np.asarray(g[name]), np.asarray(value)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_build_real_equals_the_jax_cli(artefacts, monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import train as jcli

    from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config

    monkeypatch.setattr(sys, "argv", ["train.py"] + artefacts["argv"])
    jargs = jcli.parse_args()
    jcfg, jtables, jtrain, jvals, _, jaug = jcli.build_real(
        j_tiny_test_config("hamt"), jargs)
    args = cli.parse_args(artefacts["argv"])
    cfg, world, train, vals, graphs, aug = cli.build_real(
        tiny_test_config("hamt"), args)
    for name, value in _fields(cfg.env).items():
        assert value == getattr(jcfg.env, name), name
    _assert_arrays_equal(world, jtables)
    for split, jsplit in zip([train] + vals, [jtrain] + jvals, strict=True):
        assert split.name == jsplit.name
        assert split.instr_ids == jsplit.instr_ids
        _assert_arrays_equal(split.episodes, jsplit.episodes)
    assert aug is None and jaug is None
    assert np.asarray(train.episodes.imagine_mask).any()
    assert not np.asarray(train.episodes.imagine_mask).all()


def test_eval_only_submission_from_a_reference_checkpoint(
        artefacts, tmp_path, monkeypatch, capsys):
    cfg = tiny_test_config("hamt")
    # the released-format agent save, from the port's own tiny model
    other = HamtTrainer(_replace(cfg, "train", seed=7), _tiny_world(cfg),
                        device="cpu")
    ckpt = str(tmp_path / "iter_32000_SR_67.26_SPL_62.02_val_unseen")
    torch.save({
        "vln_bert": {"epoch": 4, "state_dict": {
            "module.vln_bert." + k: v
            for k, v in other.model.state_dict().items()},
            "optimizer": {"state": {}, "param_groups": []}},
        "critic": {"epoch": 4, "state_dict": {
            "module." + k: v for k, v in other.critic.state_dict().items()},
            "optimizer": {"state": {}, "param_groups": []}},
    }, ckpt)
    monkeypatch.setattr(C, "hamt_r2r_config", lambda: cfg)
    log_dir = tmp_path / "logs"
    d = cli.main(["--eval-only", "--submit", "--init-from-reference", ckpt,
                  "--log-dir", str(log_dir), "--device", "cpu"]
                 + artefacts["argv"])
    out = capsys.readouterr().out
    assert "initialized from reference checkpoint" in out and "sr=" in out
    for k, v in other.model.state_dict().items():
        assert torch.equal(d.trainer.model.state_dict()[k], v), k
    preds = json.loads((log_dir / "submit_val_unseen.json").read_text())
    assert sorted(p["instr_id"] for p in preds) == sorted(artefacts["val_ids"])
    anno = json.loads(open(os.path.join(
        artefacts["anno"], "R2R_val_unseen_enc.json")).read())
    starts = {f"{it['path_id']}_{k}": (it["scan"], it["path"][0])
              for it in anno for k in range(2)}
    vps = {g.scan_id: set(g.node_ids) for g in artefacts["graphs"]}
    for p in preds:
        scan, start = starts[p["instr_id"]]
        assert p["trajectory"][0][0] == start
        for vp, heading, elevation in p["trajectory"]:
            assert vp in vps[scan]
            assert abs(heading) <= 2 * math.pi and abs(elevation) <= math.pi / 2
    per = json.loads((log_dir / "individual_metrics_val_unseen.json")
                     .read_text())
    assert sorted(per["instr_id"]) == sorted(artefacts["val_ids"])
    assert len(per["spl"]) == 2 * N_VAL


def _tiny_world(cfg):
    world, _ = synthetic_world(num_scans=1, num_nodes=6,
                               max_candidates=cfg.env.max_candidates,
                               views=cfg.env.views,
                               feat_dim=cfg.model.image_feat_size, seed=0)
    return world


class _Built(Exception):
    """Raised by a patched `build_real` to hand back the run's config."""


@pytest.mark.parametrize("flags", [
    ["--dataset", d] for d in ("r2r", "r2r_back", "r4r", "rxr", "cvdn",
                               "reverie", "soon")
] + [["--agent", "duet", "--dataset", d] for d in ("r2r", "r4r", "rxr",
                                                     "reverie", "soon")])
def test_dataset_routes_to_the_jax_cli_preset(flags, monkeypatch):
    """`--dataset` picks the same preset as scripts/train.py: the config
    handed to `build_real` is the JAX CLI's, field for field."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import train as jcli

    def capture(cfg, args):
        raise _Built(cfg)

    monkeypatch.setattr(jcli, "apply_platform_env", lambda: None)
    monkeypatch.setattr(jcli, "build_real", capture)
    monkeypatch.setattr(cli, "build_real", capture)
    argv = ["--anno-dir", "unused"] + flags
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    with pytest.raises(_Built) as jbuilt:
        jcli.main()
    with pytest.raises(_Built) as built:
        cli.main(argv + ["--device", "cpu"])
    import dataclasses
    got = dataclasses.asdict(built.value.args[0])
    assert got == dataclasses.asdict(jbuilt.value.args[0])
    assert got["dataset"] == flags[-1]
