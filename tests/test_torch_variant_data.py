"""The task variants' data layer in the port against the JAX package, on
HDF5 and JSON files written under tmp_path:

- `ObjectFeatureDB`, `load_obj2vps` and `build_object_tables` on the three
  object-store schemas: DUET's REVERIE store (`directions`, `sizes`, byte
  ids), SOON's (`directions`, xyxy `bboxes`, non-numeric pseudo-label
  ids, interned to negative ints) and HAMT's NavRef store (xywh `bboxes`,
  `viewindexs`), with a node holding more objects than `max_objects`;
- `ndh_episodes_from_annotations` with and without the player's path;
- the train CLI's `build_real` for `--dataset r2r_back` (ReturnBack files
  with a midstop), `--dataset reverie --obj-features` (object tables and
  target ids) and `--dataset cvdn` (NDH episodes and their goal panos):
  the same config, WorldTables, episodes and `end_panos` as
  scripts/train.py's, exactly.
"""

import dataclasses
import json
import os
import sys

import h5py
import numpy as np
import pytest

from test_torch_train_cli import REPO, _write_connectivity, _write_features
from vln_imagine_tpu.config import _replace as j_replace
from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.data import annotations as j_annotations
from vln_imagine_tpu.data import features as j_features
from vln_imagine_tpu_torch.config import _replace, tiny_test_config
from vln_imagine_tpu_torch.data import annotations, features
from vln_imagine_tpu_torch.envx.synthetic import random_scan_graph
from vln_imagine_tpu_torch.scripts import train as cli

OBJ_DIM = 16


def _graphs(n_scans=2, n_nodes=12, seed=11):
    rng = np.random.default_rng(seed)
    return [random_scan_graph(rng, f"sc{s}", n_nodes) for s in range(n_scans)]


def _write_objects(graphs, path, schema, rng):
    """Objects at a few viewpoints of every scan, one of them holding four
    (more than max_objects 3); returns {scan_vp: ids}."""
    placements = {}
    with h5py.File(path, "w") as f:
        for g in graphs:
            for node, k in ((3, 1), (5, 2), (7, 4)):
                vp = g.node_ids[node]
                ids = [f"{g.scan_id}-{node}-{j}" if schema == "soon"
                       else str(100 * node + j) for j in range(k)]
                placements[f"{g.scan_id}_{vp}"] = ids
                d = f.create_dataset(f"{g.scan_id}_{vp}", data=rng.standard_normal(
                    (k, OBJ_DIM + 4)).astype(np.float32))
                d.attrs["obj_ids"] = np.asarray([i.encode() for i in ids])
                if schema != "hamt":
                    d.attrs["directions"] = rng.uniform(
                        -1, 1, (k, 2)).astype(np.float32)
                if schema == "reverie":
                    d.attrs["sizes"] = rng.uniform(
                        10, 300, (k, 2)).astype(np.float32)
                else:
                    xy = rng.uniform(0, 300, (k, 2))
                    wh = rng.uniform(10, 200, (k, 2))
                    d.attrs["bboxes"] = np.concatenate(
                        [xy, xy + wh if schema == "soon" else wh],
                        -1).astype(np.float32)
                if schema == "hamt":
                    d.attrs["viewindexs"] = rng.integers(0, 36, k)
    return placements


@pytest.mark.parametrize("schema, bbox_format", [
    ("reverie", "xywh"), ("soon", "xyxy"), ("hamt", "xywh")])
def test_object_tables_equal_jax(tmp_path, schema, bbox_format):
    graphs = _graphs()
    path = str(tmp_path / "obj.hdf5")
    placements = _write_objects(graphs, path, schema,
                                np.random.default_rng(1))
    db = features.ObjectFeatureDB(path, OBJ_DIM)
    jdb = j_features.ObjectFeatureDB(path, OBJ_DIM)
    for key in placements:
        scan, vp = key.split("_", 1)
        (f, a), (jf, ja) = (x.load_feature(scan, vp, max_objects=3)
                            for x in (db, jdb))
        np.testing.assert_array_equal(f, jf)
        assert a.keys() == ja.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], ja[k])
        np.testing.assert_array_equal(db.box_features(a), jdb.box_features(ja))
    got = features.build_object_tables(db, graphs, 3, OBJ_DIM, max_nodes=14,
                                       bbox_format=bbox_format)
    want = j_features.build_object_tables(jdb, graphs, 3, OBJ_DIM,
                                          max_nodes=14, bbox_format=bbox_format)
    for g, w in zip(got[:5], want[:5], strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[5] == want[5]
    obj_valid = got[2]
    assert obj_valid.shape == (2, 14, 3) and obj_valid.sum() == 2 * (1 + 2 + 3)
    if schema == "soon":  # pseudo labels interned below zero
        assert (got[3][obj_valid] < 0).all()


def test_obj2vps_equals_jax(tmp_path):
    bbox = {"sc0_vpa": {"1": {"visible_pos": [3]}, "2": {"visible_pos": []}},
            "sc0_vpb": {"1": {"visible_pos": [0, 1]}},
            "sc1_vpc": {"7": {"visible_pos": [2]}}}
    path = tmp_path / "BBoxes.json"
    path.write_text(json.dumps(bbox))
    got = features.load_obj2vps(str(path))
    assert got == j_features.load_obj2vps(str(path))
    assert got == {"sc0_1": ["vpa", "vpb"], "sc1_7": ["vpc"]}


@pytest.mark.parametrize("player", [False, True])
def test_ndh_episodes_equal_jax(player):
    graphs = _graphs(n_scans=1, n_nodes=14, seed=2)
    g = graphs[0]
    items = [{"scan": "sc0", "inst_idx": 7 + i,
              "start_pano": g.node_ids[i], "start_heading": 0.5 * i,
              "end_panos": [g.node_ids[5 + i], g.node_ids[9 + i]],
              "instr_encoding": [1, 11 + i, 12, 13],
              "nav_steps": [g.node_ids[i], g.node_ids[(i + 2) % 14]],
              "nav_idx": 0} for i in range(4)]
    items.append({"scan": "sc0", "inst_idx": 20,  # no goal panos
                  "start_pano": g.node_ids[1], "instr_encoding": [1, 5]})
    kw = dict(max_instr_len=8, max_gt_path_len=25, max_imaginations=2,
              use_player_path=player)
    ep, ids, ends = annotations.ndh_episodes_from_annotations(
        items, graphs, rng=np.random.default_rng(0), **kw)
    jep, jids, jends = j_annotations.ndh_episodes_from_annotations(
        items, graphs, rng=np.random.default_rng(0), **kw)
    assert ids == jids and ends == jends
    for f in dataclasses.fields(ep):  # the JAX batch adds imagine_images
        want = getattr(jep, f.name)
        if want is None:
            assert getattr(ep, f.name) is None, f.name
            continue
        np.testing.assert_array_equal(getattr(ep, f.name), want,
                                      err_msg=f.name)
    assert ends[-1] == [1]


# ------------------------------------------------------- build_real per task
def _write_task_files(root, dataset, graphs, rng):
    """The split files of `dataset` in its layout, two items a split."""
    anno = root / "annotations"
    sub = {"r2r_back": "ReturnBack"}.get(dataset, "")
    (anno / sub).mkdir(parents=True, exist_ok=True)
    for split, base in (("train", 0), ("val_unseen", 10)):
        items = []
        for j in range(2):
            g = graphs[j % len(graphs)]
            path = [g.node_ids[n] for n in (j, j + 1, j + 2)]
            enc = [1] + [int(t) for t in rng.integers(4, 60, 5)]
            item = {"scan": g.scan_id, "path_id": base + j, "path": path,
                    "heading": 0.3 * j, "instructions": ["go on."] * 2,
                    "instr_encodings": [enc, enc[:3]]}
            if dataset == "r2r_back":
                item["midstop"] = path[1]
            if dataset == "reverie":
                item["objId"] = 501 + j
            if dataset == "cvdn":
                item = {"scan": g.scan_id, "path_id": base + j,
                        "start_pano": path[0], "start_heading": 0.3 * j,
                        "end_panos": [path[2], g.node_ids[9]],
                        "nav_steps": path[:2], "nav_idx": 0,
                        "instructions": ["dialog."], "instr_encodings": [enc]}
            items.append(item)
        name = {"reverie": f"REVERIE_{split}_enc.json",
                "cvdn": f"{split}_enc.json"}.get(dataset,
                                                 f"R2R_{split}_enc.json")
        (anno / sub / name).write_text(json.dumps(items))
    return str(anno)


@pytest.mark.parametrize("dataset", ["r2r_back", "reverie", "cvdn"])
def test_build_real_equals_the_jax_cli(tmp_path, dataset, monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import train as jcli

    rng = np.random.default_rng(4)
    graphs = _graphs()
    cfg = tiny_test_config("hamt")
    _write_connectivity(graphs, str(tmp_path / "conn"))
    _write_features(graphs, str(tmp_path / "feat.hdf5"), cfg.env.views,
                    cfg.model.image_feat_size, rng)
    argv = ["--dataset", dataset, "--connectivity-dir", str(tmp_path / "conn"),
            "--anno-dir", _write_task_files(tmp_path, dataset, graphs, rng),
            "--img-features", str(tmp_path / "feat.hdf5"),
            "--splits", "train", "val_unseen"]
    obj = dict(obj_feat_size=OBJ_DIM) if dataset == "reverie" else {}
    if obj:
        _write_objects(graphs, str(tmp_path / "obj.hdf5"), "hamt", rng)
        argv += ["--obj-features", str(tmp_path / "obj.hdf5"),
                 "--max-objects", "3"]
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    jcfg, jworld, jtrain, jvals, _, _ = jcli.build_real(
        j_replace(j_tiny_test_config("hamt"), "model", **obj).replace(
            dataset=dataset), jcli.parse_args())
    pcfg, world, train, vals, _, _ = cli.build_real(
        _replace(cfg, "model", **obj).replace(dataset=dataset),
        cli.parse_args(argv))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    for f in dataclasses.fields(world):
        want = getattr(jworld, f.name)
        if want is None:
            assert getattr(world, f.name) is None, f.name
            continue
        np.testing.assert_array_equal(getattr(world, f.name), want,
                                      err_msg=f.name)
    for split, jsplit in zip([train] + vals, [jtrain] + jvals, strict=True):
        assert split.instr_ids == jsplit.instr_ids
        assert split.end_panos == jsplit.end_panos
        for f in dataclasses.fields(split.episodes):
            want = getattr(jsplit.episodes, f.name)
            if want is None:
                assert getattr(split.episodes, f.name) is None, f.name
                continue
            np.testing.assert_array_equal(getattr(split.episodes, f.name),
                                          want, err_msg=f.name)
    ep = train.episodes
    if dataset == "r2r_back":
        assert (ep.midstop >= 0).all()
    if dataset == "reverie":
        assert world.obj_valid.any() and (ep.gt_obj_id >= 501).all()
    if dataset == "cvdn":
        assert train.end_panos and all(train.end_panos)
