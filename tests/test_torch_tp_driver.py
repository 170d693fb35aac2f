"""The port's FinetuneDriver on a mesh of one data rank and a model axis of
2 (two gloo processes on the CPU; parameters of at least 2^10 elements
split), against the one-process driver on the same splits (HAMT, tiny
config, batch 4):

- `validate` before training and after `run(iters=2)` equals the
  one-process scores exactly, with the same submission and per-item metric
  files (rank 0 writes them), and the trained whole parameters' abs-sum
  within 2e-5;
- rank 0 saves every checkpoint, rank 1 none; a fault on rank 1 alone
  rolls both back to `latest_dict` bitwise;
- the checkpoint holds whole tensors; a fresh driver on the mesh reports
  the file's state bitwise and holds its slices of it bitwise.

And the CLI's `--mesh-model` without a launcher.
"""

import json

import numpy as np
import pytest
import torch

from _torch_dp import run_driver, spawn

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_driver")
    ranks = spawn("tp_driver", out, world=2, model=2, timeout=300)
    return ranks, run_driver(out / "one"), out


def test_tp_validate_equals_one_process(runs):
    ranks, one, _ = runs
    for r in ranks:
        assert r["score0"] == one["score0"]
        assert r["score2"] == one["score2"]
    sums = [sum(float(v.abs().sum()) for v in x["trained"].values())
            for x in (ranks[0], one)]
    np.testing.assert_allclose(sums[0], sums[1], rtol=2e-5)


@pytest.mark.parametrize("name", ["submit_val_unseen.json",
                                  "individual_metrics_val_unseen.json"])
def test_tp_outputs_equal_one_process(runs, name):
    _, _, out = runs
    got, want = ((out / d / name).read_text() for d in ("run", "one"))
    assert got == want
    data = json.loads(got)
    ids = (data["instr_id"] if isinstance(data, dict)
           else [item["instr_id"] for item in data])
    assert sorted(ids) == [f"val_unseen_{i}" for i in range(6)]


def test_tp_only_rank_0_saves_and_a_fault_rolls_both_back(runs):
    ranks, one, out = runs
    assert ranks[0]["saves"] == one["saves"] and ranks[1]["saves"] == []
    for r in ranks:
        assert r["trained"].keys() == one["trained"].keys()
        for k, v in r["trained"].items():
            assert v.shape == one["trained"][k].shape, k
            assert torch.equal(r["after_rollback"][k], v), k
            assert torch.equal(ranks[1]["trained"][k], ranks[0]["trained"][k])
    record = (out / "run" / "train.txt").read_text()
    assert "another rank's interval failed" in record
    assert "rolled back to latest_dict" in record


def _states_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_states_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_states_equal, a, b))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.shape == b.shape and torch.equal(a, b)
    return a == b


def test_tp_checkpoint_is_whole_and_reloads_into_slices(runs):
    ranks, one, out = runs
    saved = torch.load(out / "run" / "ckpts" / "latest_dict",
                       weights_only=True)
    shapes = {k: v.shape for k, v in one["trained"].items()}
    assert {k: v.shape for k, v in saved["vln_bert"]["state_dict"].items()
            } == shapes
    for r in ranks:
        rl = r["reload"]
        assert _states_equal(rl["saved"], saved)
        assert _states_equal(rl["state"], saved)
        assert all(same for same, _ in rl["local"].values())
        assert sum(split for _, split in rl["local"].values()) > 0


def test_cli_mesh_model_without_a_launcher(tmp_path):
    """`--mesh-model 2` without `--mesh-data` runs one process without a
    mesh, as the JAX package's CLI; with `--mesh-data 1` it needs 2
    launched processes and exits, leaving no process group."""
    import torch.distributed as dist

    from vln_imagine_tpu_torch.scripts import train as cli

    base = ["--synthetic", "--device", "cpu", "--iters", "1", "--log-every",
            "1"]
    d = cli.main(base + ["--mesh-model", "2", "--log-dir", str(tmp_path / "a")])
    assert d.mesh is None and d.cfg.mesh.model_parallelism == 1
    assert not dist.is_initialized()
    with pytest.raises(SystemExit, match="does not match the 1 launched"):
        cli.main(base + ["--mesh-data", "1", "--mesh-model", "2",
                         "--log-dir", str(tmp_path / "b")])
    assert not dist.is_initialized()
