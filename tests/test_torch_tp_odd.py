"""The model axis where it does not split the heads evenly, and at one
process, on the CPU:

- hidden 48 over 3 heads (`_torch_dp.ODD_HEADS`), at a model axis of 2: a
  rank's columns of q, k and v are one and a half heads, so they are
  gathered and every rank runs every head; at 3: one head a rank, and the
  [48, 512] critic and alignment-head kernels split on their input axis
  (their partial products summed over the ranks).  Greedy eval of both
  agents (paths and lengths identical to one process, first-step logits
  within 1e-4), the HAMT `sample` step with its critic and the DUET DAgger
  step with every dropout on (metrics within 1e-4, the updated whole
  parameters' abs-sum within 2e-5 relative, the critic within 1e-4).
- A mesh of one process (1 x 1, a one-process group in this process):
  the tiny configs' eval and dropout steps bitwise what they are without a
  mesh.
"""

import numpy as np
import pytest
import torch

from _torch_dp import (
    finish,
    odd_train_cases,
    start,
    tp_eval_cases,
    train_cases,
    trainer,
    world_and_episodes,
)
from vln_imagine_tpu_torch.config import tiny_test_config

torch.set_num_threads(2)

AXES = (2, 3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_odd")
    procs = {}
    for m in AXES:
        (out / f"m{m}").mkdir()
        procs[m] = start("tp_odd", out / f"m{m}", world=m, model=m)
    try:
        one = {"eval": tp_eval_cases(None, out, odd=True),
               "train": odd_train_cases(None)}
    except BaseException:
        for ps in procs.values():
            for p in ps:
                p.kill()
                p.wait()
        raise
    return ({m: finish(procs[m], "tp_odd", out / f"m{m}", timeout=300)
             for m in AXES}, one)


def _param_sum(sd) -> float:
    return sum(float(v.double().abs().sum()) for v in sd.values())


@pytest.mark.parametrize("m", AXES)
@pytest.mark.parametrize("agent", ["hamt", "duet"])
def test_odd_heads_eval_equals_one_process(runs, agent, m):
    ranks, one = runs
    want = one["eval"][agent]
    for res in ranks[m]:
        got = res["eval"][agent]
        np.testing.assert_array_equal(got["lens"], want["lens"])
        np.testing.assert_array_equal(got["paths"], want["paths"])
        finite = np.isfinite(want["logits"])
        np.testing.assert_array_equal(np.isfinite(got["logits"]), finite)
        np.testing.assert_allclose(got["logits"][finite],
                                   want["logits"][finite], rtol=0, atol=1e-4)


@pytest.mark.parametrize("m", AXES)
@pytest.mark.parametrize("case", ["hamt_odd", "duet_odd"])
def test_odd_heads_step_matches_one_process(runs, case, m):
    ranks, one = runs
    want = one["train"][case]
    for res in ranks[m]:
        got = res["train"][case]
        assert got["metrics"] == ranks[m][0]["train"][case]["metrics"]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(_param_sum(got["model"]),
                                   _param_sum(want["model"]), rtol=2e-5)
        for k, v in want.get("critic", {}).items():
            torch.testing.assert_close(got["critic"][k], v, rtol=1e-4,
                                       atol=1e-6)


def test_a_mesh_of_one_process_is_bitwise_no_mesh(tmp_path):
    import torch.distributed as dist

    from vln_imagine_tpu_torch.parallel.distributed import initialize
    from vln_imagine_tpu_torch.parallel.mesh import make_mesh

    cfg = tiny_test_config("hamt")
    world, _, _ = world_and_episodes(cfg, 2)
    torch.save(trainer("hamt", cfg, world, seed=11).model.state_dict(),
               tmp_path / "hamt_eval_init.pt")

    def cases(mesh):
        return {"eval": tp_eval_cases(mesh, tmp_path),
                "train": train_cases(mesh, tmp_path, teacher=False)}

    plain = cases(None)
    initialize(device="cpu", timeout=60)
    try:
        got = cases(make_mesh(data=1, model=1))
    finally:
        dist.destroy_process_group()
    for agent, want in plain["eval"].items():
        for key in ("paths", "lens", "logits"):
            np.testing.assert_array_equal(got["eval"][agent][key], want[key])
    assert got["train"].keys() == plain["train"].keys()
    for case, want in plain["train"].items():
        assert got["train"][case]["metrics"] == want["metrics"], case
        for part in ("model", "critic"):
            for k, v in want.get(part, {}).items():
                assert torch.equal(got["train"][case][part][k], v), (case, k)
