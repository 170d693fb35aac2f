"""Finds what a cell is made of by the names in `BENCHMARK.json`.

Under `<root>/portbench/`:

- `configs/<config>.json`: a configuration's widths, what it assumes and
  which agent module (`portbench/agents/<agent>.py`) drives it;
- `traffic/<traffic>.json`: a traffic mix's parameters, read by the
  agent's cell of that `kind`;
- `limits/<workload>.json`: each number the check compares, with its limit;
- `metrics/<metric>.py`: the metric's reader, `read(ctx)` -> a number or
  None where it finds nothing to read; a name `base.part` falls back to
  `base.py`, so `mfu.eval` and `mfu.train` share a reader;
- `kernels/<family>/*.json`: name patterns of one family of kernels
  (`{"patterns": [...]}`), all files of the family together;
- `peaks.json`: the published peaks of each card.

A later cell, metric or kernel is new files and `BENCHMARK.json` entries;
no file here needs an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path


class Registry:
    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, *parts):
        return json.loads(self.dir.joinpath(*parts).read_text())

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.bench["configs"] if c["name"] == name)
        cfg = json.loads((self.root / entry["file"]).read_text())
        cfg["file"] = entry["file"]
        return cfg

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name + ".json")

    def limits(self, workload: str) -> dict:
        path = self.dir / "limits" / (workload + ".json")
        return json.loads(path.read_text()) if path.exists() else {}

    def peaks(self) -> list:
        return self._json("peaks.json")["cards"]

    def kernel_patterns(self, family: str) -> list:
        pats = []
        for f in sorted((self.dir / "kernels" / family).glob("*.json")):
            pats += json.loads(f.read_text())["patterns"]
        return pats

    def metrics(self, workload: str, section: str) -> list:
        """The entries of `section` ('end_to_end' or 'per_layer') that this
        workload reports."""
        return [m for m in self.bench[section]
                if workload in m.get("workloads", [workload])]

    def reader(self, name: str):
        mdir = self.dir / "metrics"
        path = mdir / (name + ".py")
        if not path.exists():
            path = mdir / (name.split(".")[0] + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def agent(self, config: dict):
        return importlib.import_module("portbench.agents." + config["agent"])
