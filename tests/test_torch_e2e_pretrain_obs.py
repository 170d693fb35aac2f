"""The E2E pre-training tasks with observation tokens (sap, sar, sprel)
against the JAX package's: batches bitwise, loss, counts and every
gradient within 1e-4, and the ViT's gradient from the history views and
the observations alone (see tests/test_torch_e2e_pretrain.py, which runs
mlm, mrc and itm with the same checks)."""

import pytest
import torch

from tests.test_torch_e2e_pretrain import check_task, make_setup

torch.set_num_threads(2)

FILE_TASKS = ("sap", "sar", "sprel")


@pytest.fixture(scope="module")
def setup():
    return make_setup(FILE_TASKS)


def test_bridge_covers_every_leaf(setup):
    from vln_imagine_tpu.ckpt.convert import verify_converted
    from vln_imagine_tpu_torch.ckpt.convert import flax_from_state_dict

    _, params, port, _ = setup
    assert verify_converted(flax_from_state_dict(
        port.state_dict(), "hamt_e2e_pretrain"), params) == []


@pytest.mark.parametrize("task", FILE_TASKS)
def test_e2e_task_loss_and_grads_match_jax(setup, task):
    check_task(setup, task)
