"""The port's `parallel/distributed.py` against the JAX package's cases:

- two gloo processes (file rendezvous) run the case list of the JAX
  package's `test_multihost.py::test_two_process_collectives`: the object
  gather in rank order over unequal payloads, `reduce_dict` mean and sum,
  the contiguous shards and the merged ids;
- one process, no group: the byte path of `all_gather_objects` (the cases
  of `test_mesh.py::test_all_gather_objects_byte_path`, the same bytes as
  the JAX package's helpers) and every function at one process;
- a one-process group on an in-process store.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dp import spawn
from vln_imagine_tpu.parallel import distributed as JD
from vln_imagine_tpu_torch.parallel import distributed as D
from vln_imagine_tpu_torch.parallel.mesh import DataShard, make_mesh

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return spawn("collectives", tmp_path_factory.mktemp("collectives"),
                 timeout=120)


def test_two_process_object_gather_in_rank_order(two_ranks):
    for pid, r in enumerate(two_ranks):
        assert r["default"] == (pid == 0)
        assert r["ranks"] == [0, 1]
        assert r["n_preds"] == [2, 5]


def test_two_process_reduce_dict(two_ranks):
    for r in two_ranks:
        assert r["reduced"] == {"loss": 1.5, "n": 15.0}
        assert r["summed"] == {"loss": 3.0}


def test_two_process_merged_ids(two_ranks):
    for r in two_ranks:
        assert r["merged_ids"] == sorted(
            [f"i0_{j}" for j in range(2)] + [f"i1_{j}" for j in range(5)])


def test_two_process_contiguous_shards(two_ranks):
    assert two_ranks[0]["shard"] == [0, 5]
    assert two_ranks[1]["shard"] == [5, None]


BYTE_CASES = [{"instr_id": "4332_1", "trajectory": [[1, 2], [3, 4]]},
              ["short"],
              {"nested": {"a": np.arange(3).tolist(), "b": None}}]


@pytest.mark.parametrize("obj", BYTE_CASES, ids=["dict", "list", "nested"])
def test_all_gather_objects_byte_path(obj):
    """The encode -> pad -> decode bytes round-trip among ragged payloads,
    equal to the JAX package's helpers' bytes."""
    payloads = [D._encode_payload(o) for o in BYTE_CASES]
    for p, o in zip(payloads, BYTE_CASES):
        np.testing.assert_array_equal(p, JD._encode_payload(o))
    sizes = np.asarray([p.size for p in payloads], np.int64)
    gathered = np.stack([D._pad_payload(p, int(sizes.max())) for p in payloads])
    assert D._decode_payloads(gathered, sizes) == BYTE_CASES
    assert D.all_gather_objects(obj) == [obj]


def test_single_process_without_a_group():
    assert not dist.is_initialized()
    assert D.process_count() == 1 and D.process_index() == 0
    assert D.is_default_process()
    assert D.shard_indices(10) == slice(0, None)
    assert D.shard_indices(10, 1, 2) == slice(5, None)
    assert D.shard_indices(10, 0, 3) == JD.shard_indices(10, 0, 3)
    m = {"loss": 1.25, "n": 3.0}
    assert D.reduce_dict(m) == m and D.reduce_dict(m) is not m
    rows = [[{"instr_id": "a", "v": 0}, {"instr_id": "b", "v": 1}],
            [{"instr_id": "a", "v": 2}, {"instr_id": "c", "v": 3}]]
    assert D.merge_results(rows) == JD.merge_results(rows)
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh(data=1)
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh(data=1, model=2)  # a model axis needs the group too
    with pytest.raises(ValueError, match="init_method"):
        D.initialize(world_size=2, rank=0, device="cpu")


def test_one_process_group_on_an_in_process_store():
    dev = D.initialize(device="cpu", timeout=30)
    try:
        assert dev == torch.device("cpu")
        assert dist.get_backend() == "gloo" and D.process_count() == 1
        mesh = make_mesh()
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="mesh 1x2 != 1 processes"):
            make_mesh(data=1, model=2)
        with pytest.raises(ValueError, match="mesh 0x2 != 1 processes"):
            make_mesh(model=2)
        shard = DataShard.of(mesh)
        assert (shard.rank, shard.size) == (0, 1)
        x = torch.tensor([1.5, -2.0])
        assert torch.equal(shard.sum(x), x) and torch.equal(shard.gather(x), x)
        assert D.all_gather_objects({"a": 1}) == [{"a": 1}]
        assert D.reduce_dict({"loss": 2.0}) == {"loss": 2.0}
    finally:
        dist.destroy_process_group()
