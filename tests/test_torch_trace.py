"""The device-time trace's interval arithmetic and kernel names, on the CPU
(the trace itself needs the card)."""

import re
from pathlib import Path

import pytest
import torch

from vln_imagine_tpu_torch.eval.trace import ATTENTION_KERNELS, _busy_us
from vln_imagine_tpu_torch.ops.attention import CSRC

torch.set_num_threads(2)


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 2.0), (5.0, 6.0)], 3.0),           # disjoint
    ([(0.0, 4.0), (1.0, 2.0)], 4.0),           # nested
    ([(3.0, 5.0), (0.0, 2.0), (1.5, 4.0)], 5.0),  # overlapping, unsorted
])
def test_busy_time_is_the_union_of_intervals(intervals, want):
    assert _busy_us(intervals) == want


@pytest.mark.parametrize("fn_name", sorted(ATTENTION_KERNELS))
def test_traced_kernel_names_are_kernels_of_their_source(fn_name):
    """A renamed CUDA function would drop out of the trace's attention shares
    without an error: each traced name is a __global__ of its source."""
    _, source = ATTENTION_KERNELS[fn_name]
    text = Path(CSRC, source).read_text()
    bounds = r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+"
    assert re.search(r"__global__\s+void\s+(?:" + bounds + ")?"
                     + re.escape(fn_name) + r"\s*\(", text), (fn_name, source)
