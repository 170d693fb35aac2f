"""The port's FinetuneDriver on a data mesh of two gloo processes on the
CPU, against the one-process driver on the same splits (HAMT, tiny config,
batch 4, so each rank trains on 2 rows and validates 2 of every 4 items):

- `validate` before training equals the one-process scores exactly, and
  after `run(iters=2)` too, with the same submission and per-item metric
  files (rank 0 writes them);
- rank 0 saves every checkpoint and rank 1 none;
- a fault on rank 1 alone rolls both ranks back to `latest_dict`: they end
  with the state they had before the interval, bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from _torch_dp import run_driver, spawn

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_driver")
    ranks = spawn("driver", out, timeout=300)
    return ranks, run_driver(out / "one"), out


def test_two_rank_validate_equals_one_process(runs):
    ranks, one, _ = runs
    for r in ranks:
        assert r["score0"] == one["score0"]
        assert r["score2"] == one["score2"]
    sums = [sum(float(v.abs().sum()) for v in x["trained"].values())
            for x in (ranks[0], one)]
    np.testing.assert_allclose(sums[0], sums[1], rtol=2e-5)


@pytest.mark.parametrize("name", ["submit_val_unseen.json",
                                  "individual_metrics_val_unseen.json"])
def test_two_rank_outputs_equal_one_process(runs, name):
    _, _, out = runs
    got, want = ((out / d / name).read_text() for d in ("run", "one"))
    assert got == want
    data = json.loads(got)
    ids = (data["instr_id"] if isinstance(data, dict)
           else [item["instr_id"] for item in data])
    assert sorted(ids) == [f"val_unseen_{i}" for i in range(6)]


def test_only_rank_0_saves(runs):
    ranks, one, out = runs
    assert ranks[0]["saves"] == one["saves"]
    assert "save_latest" in ranks[0]["saves"]
    assert ranks[1]["saves"] == []
    assert (out / "run" / "ckpts" / "latest_dict").exists()


def test_a_fault_on_one_rank_rolls_both_back(runs):
    ranks, _, out = runs
    for r in ranks:
        for k, v in r["trained"].items():
            assert torch.equal(r["after_rollback"][k], v), k
    for k, v in ranks[0]["after_rollback"].items():
        assert torch.equal(ranks[1]["after_rollback"][k], v), k
    record = (out / "run" / "train.txt").read_text()
    assert "another rank's interval failed" in record
    assert "rolled back to latest_dict" in record


def test_cli_mesh_without_a_launcher(tmp_path):
    """`--mesh-data 1` (and -1) runs in one process on an in-process
    group, which it leaves again; a size other than the launched processes
    exits."""
    import torch.distributed as dist

    from vln_imagine_tpu_torch.scripts import train as cli

    base = ["--synthetic", "--device", "cpu", "--iters", "1", "--log-every",
            "1"]
    for n in ("1", "-1"):
        d = cli.main(base + ["--mesh-data", n, "--log-dir", str(tmp_path / n)])
        assert d.shard.size == 1 and d.cfg.mesh.data_parallelism == 1
        assert (tmp_path / n / "ckpts" / "latest_dict").exists()
        assert not dist.is_initialized()
    with pytest.raises(SystemExit, match="does not match the 1 launched"):
        cli.main(base + ["--mesh-data", "2", "--log-dir", str(tmp_path / "x")])
    assert not dist.is_initialized()


def test_cli_under_torchrun_on_two_processes(tmp_path):
    """The train CLI under `torch.distributed.run --nproc-per-node 2` with
    `--mesh-data 2` on the CPU (gloo): both ranks train and validate, rank
    0 writes the run's files."""
    import os
    import subprocess
    import sys

    from _torch_dp import REPO

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "vln_imagine_tpu_torch.scripts.train",
         "--synthetic", "--device", "cpu", "--mesh-data", "2", "--batch-size",
         "4", "--iters", "2", "--log-every", "1", "--log-dir", str(tmp_path)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    record = (tmp_path / "train.txt").read_text()
    assert record.count("iter ") == 2, record
    assert (tmp_path / "ckpts" / "latest_dict").exists()
