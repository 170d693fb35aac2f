"""The device-time trace's interval arithmetic, on the CPU (the trace itself
needs the card)."""

import pytest
import torch

from vln_imagine_tpu_torch.eval.trace import _busy_us

torch.set_num_threads(2)


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 2.0), (5.0, 6.0)], 3.0),           # disjoint
    ([(0.0, 4.0), (1.0, 2.0)], 4.0),           # nested
    ([(3.0, 5.0), (0.0, 2.0), (1.5, 4.0)], 5.0),  # overlapping, unsorted
])
def test_busy_time_is_the_union_of_intervals(intervals, want):
    assert _busy_us(intervals) == want
