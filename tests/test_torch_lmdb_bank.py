"""The port's LMDB reader (data/lmdb_reader.py) and LMDB -> RawPanoramaBank
converter (scripts/convert_lmdb_bank.py) in the cases of the JAX
package's tests/test_lmdb_bank.py, over that file's independent LMDB writer:
the reader's round trip, a multi-leaf tree, an environment directory,
garbage refused; the converter's bank at the released geometry byte for
byte the JAX script's (and the reference eval transform), missing
viewpoints raised or zero-filled; an off-geometry store resized as the JAX
script resizes it, and refused with a clear message where Pillow is
missing."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from tests.test_lmdb_bank import PSIZE, write_lmdb
from test_dress_rehearsal import _write_connectivity
from vln_imagine_tpu_torch.config import hamt_r2r_config
from vln_imagine_tpu_torch.data.features import RawPanoramaBank
from vln_imagine_tpu_torch.data.lmdb_reader import LmdbFormatError, LmdbReader
from vln_imagine_tpu_torch.envx import synthetic_world
from vln_imagine_tpu_torch.scripts import convert_lmdb_bank as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    """The JAX package's scripts/convert_lmdb_bank.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_convert_lmdb_bank",
        os.path.join(REPO, "scripts", "convert_lmdb_bank.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reader_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    kvs = {f"key_{i:03d}".encode(): rng.integers(0, 256, size=n,
                                                 dtype=np.uint8).tobytes()
           for i, n in enumerate([3, 40, 700, 5000, 9000, 0, 12345])}
    path = write_lmdb(str(tmp_path / "tiny.mdb"), kvs)
    with LmdbReader(path) as db:
        assert len(db) == len(kvs)
        assert {k: bytes(v) for k, v in db.items()} == kvs
        for k, v in kvs.items():
            assert bytes(db.get(k)) == v
        assert db.get(b"nope") is None


def test_reader_multi_leaf_branch(tmp_path):
    rng = np.random.default_rng(1)
    kvs = {f"{i:05d}".encode(): rng.integers(0, 256, size=400,
                                             dtype=np.uint8).tobytes()
           for i in range(40)}
    path = write_lmdb(str(tmp_path / "multi.mdb"), kvs)
    with LmdbReader(path) as db:
        assert list(db.keys()) == sorted(kvs)  # in-order traversal
        assert bytes(db.get(b"00037")) == kvs[b"00037"]


def test_reader_accepts_env_directory(tmp_path):
    path = write_lmdb(str(tmp_path / "env"), {b"a": b"1"}, subdir=True)
    assert os.path.basename(path) == "data.mdb"
    with LmdbReader(str(tmp_path / "env")) as db:
        assert bytes(db.get(b"a")) == b"1"


def test_reader_rejects_garbage(tmp_path):
    p = tmp_path / "junk.mdb"
    p.write_bytes(b"\0" * (2 * PSIZE))
    with pytest.raises(LmdbFormatError):
        LmdbReader(str(p))


def _store(tmp_path, shape, nodes=3, seed=4):
    """Connectivity and an LMDB store of `shape` uint8 panoramas a
    viewpoint."""
    cfg = hamt_r2r_config()
    _, graphs = synthetic_world(
        num_scans=2, num_nodes=nodes, max_candidates=cfg.env.max_candidates,
        views=36, feat_dim=8, seed=3, with_features=False)
    conn = str(tmp_path / "connectivity")
    _write_connectivity(graphs, conn)
    rng = np.random.default_rng(seed)
    kvs, raw = {}, {}
    for g in graphs:
        for vp in g.node_ids:
            frames = rng.integers(0, 256, size=shape, dtype=np.uint8)
            raw[(g.scan_id, vp)] = frames
            kvs[f"{g.scan_id}_{vp}".encode("ascii")] = frames.tobytes()
    return graphs, conn, kvs, raw


def _argv(lmdb, out, conn, graphs, *extra):
    # synthetic node ids hold '_', so the scans are named explicitly
    return (["--lmdb", lmdb, "--out", out, "--connectivity-dir", conn,
             "--image-size", "224", "--scans"]
            + sorted(g.scan_id for g in graphs) + list(extra))


def test_convert_lmdb_to_bank(tmp_path, capsys):
    """The released geometry (36, 248, 330, 3): the port's bank equals the
    JAX script's byte for byte and the reference eval transform (identity
    resize, centre crop, [-1, 1]); a missing viewpoint raises, naming its
    key, or with --allow-missing is zero-filled."""
    graphs, conn, kvs, raw = _store(tmp_path, (36, 248, 330, 3))
    write_lmdb(str(tmp_path / "img_db"), kvs, subdir=True)
    out, jout = str(tmp_path / "panos.npy"), str(tmp_path / "jax.npy")
    meta = cli.main(_argv(str(tmp_path / "img_db"), out, conn, graphs))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == meta
    jax_script = _jax_script()
    jmeta = jax_script.convert(jax_script.parse_args(
        _argv(str(tmp_path / "img_db"), jout, conn, graphs)))
    assert {k: v for k, v in meta.items() if k != "out"} == \
        {k: v for k, v in jmeta.items() if k != "out"}
    assert meta["converted"] == sum(g.num_nodes for g in graphs)
    assert meta["missing"] == 0 and os.path.isfile(out + ".meta.json")
    bank = np.load(out, mmap_mode="r")
    assert np.array_equal(bank, np.load(jout, mmap_mode="r"))
    assert RawPanoramaBank(out, 224).shape == (2, 3, 36, 224, 224, 3)
    order = {g.scan_id: g for g in graphs}
    for s, scan_id in enumerate(meta["scans"]):
        for i, vp in enumerate(order[scan_id].node_ids):
            want = raw[(scan_id, vp)][:, 12:236, 53:277].astype(
                np.float32) / 127.5 - 1.0
            np.testing.assert_array_equal(bank[s, i], want)
    del bank

    dropped = f"{graphs[0].scan_id}_{graphs[0].node_ids[2]}"
    write_lmdb(str(tmp_path / "img_db2"), {
        k: v for k, v in kvs.items() if k != dropped.encode("ascii")},
        subdir=True)
    with pytest.raises(KeyError, match=dropped):
        cli.main(_argv(str(tmp_path / "img_db2"), str(tmp_path / "p2.npy"),
                       conn, graphs))
    meta = cli.main(_argv(str(tmp_path / "img_db2"), str(tmp_path / "p3.npy"),
                          conn, graphs, "--allow-missing"))
    assert meta["missing"] == 1
    s3 = meta["scans"].index(graphs[0].scan_id)
    bank3 = np.load(str(tmp_path / "p3.npy"), mmap_mode="r")
    np.testing.assert_array_equal(bank3[s3, 2], 0.0)


def test_off_geometry_resize_and_missing_pillow(tmp_path, monkeypatch):
    """A store at 120 x 160 is resized (bicubic, shorter side to 248) as
    the JAX script resizes it; without Pillow the port stops and says
    why."""
    pytest.importorskip("PIL")
    graphs, conn, kvs, _ = _store(tmp_path, (36, 120, 160, 3), nodes=2)
    write_lmdb(str(tmp_path / "img_db"), kvs, subdir=True)
    geometry = ["--src-height", "120", "--src-width", "160"]
    out, jout = str(tmp_path / "panos.npy"), str(tmp_path / "jax.npy")
    cli.main(_argv(str(tmp_path / "img_db"), out, conn, graphs, *geometry))
    jax_script = _jax_script()
    jax_script.convert(jax_script.parse_args(
        _argv(str(tmp_path / "img_db"), jout, conn, graphs, *geometry)))
    assert np.array_equal(np.load(out), np.load(jout))
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL now fails
    with pytest.raises(SystemExit, match="needs Pillow"):
        cli.main(_argv(str(tmp_path / "img_db"), str(tmp_path / "x.npy"),
                       conn, graphs, *geometry))
