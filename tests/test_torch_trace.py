"""The device-time trace's interval arithmetic, and the kernel names the
benchmark's roofline reads, on the CPU (the trace itself needs the card)."""

import json
import re
from pathlib import Path

import pytest

from chip_smoke import _busy_us

REPO = Path(__file__).resolve().parents[1]
KERNELS = REPO / "portbench" / "kernels"


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 2.0), (5.0, 6.0)], 3.0),           # disjoint
    ([(0.0, 4.0), (1.0, 2.0)], 4.0),           # nested
    ([(3.0, 5.0), (0.0, 2.0), (1.5, 4.0)], 5.0),  # overlapping, unsorted
])
def test_busy_time_is_the_union_of_intervals(intervals, want):
    assert _busy_us(intervals) == want


def _sources() -> dict:
    """Each attention kernel pattern the benchmark's roofline reads, with
    the source file its entry names."""
    out = {}
    for f in sorted((KERNELS / "attention").glob("*.json")):
        entry = json.loads(f.read_text())
        out.update(dict.fromkeys(entry["patterns"],
                                 entry["source"].split(":")[0]))
    return out


@pytest.mark.parametrize("fn_name", sorted(_sources()))
def test_traced_kernel_names_are_kernels_of_their_source(fn_name):
    """A renamed CUDA function would drop out of the roofline's kernel time
    without an error: each pattern is a __global__ of its source."""
    source = _sources()[fn_name]
    text = (REPO / source).read_text()
    bounds = r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+"
    assert re.search(r"__global__\s+void\s+(?:" + bounds + ")?"
                     + re.escape(fn_name) + r"\s*\(", text), (fn_name, source)
