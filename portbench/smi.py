"""The card's name, power limit, clocks and power draw, from `nvidia-smi`.

`card()` reads the static facts once; `Sampler` polls the clocks, power
and temperature once a second beside the window in one child process,
which `stop()` ends and waits for.  Where `nvidia-smi` is missing or
fails, the facts read None: they describe a run, they decide nothing.
"""

from __future__ import annotations

import statistics
import subprocess

QUERY = "clocks.sm,clocks.mem,power.draw,temperature.gpu"


def _query(fields: str, timeout: float = 30.0):
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=timeout, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return [x.strip() for x in out.splitlines()[0].split(",")]


def card() -> dict:
    row = _query("name,power.limit,clocks.max.sm")
    if row is None:
        return {"name": None, "power_limit_w": None, "max_sm_clock_mhz": None}
    return {"name": row[0], "power_limit_w": _num(row[1]),
            "max_sm_clock_mhz": _num(row[2])}


def _num(x):
    try:
        return float(x)
    except ValueError:
        return None


class Sampler:
    def __init__(self, interval_ms: int = 1000):
        self.interval_ms = interval_ms
        self.proc = None

    def start(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={QUERY}",
                 "--format=csv,noheader,nounits", f"-lms={self.interval_ms}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def stop(self) -> dict:
        """Ends the poller and summarises its samples: min, median and max
        of each field."""
        if self.proc is None:
            return {}
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = [[_num(x.strip()) for x in line.split(",")]
                for line in out.splitlines() if line.count(",") == 3]
        summary = {"samples": len(rows)}
        for k, name in enumerate(QUERY.split(",")):
            vals = [r[k] for r in rows if r[k] is not None]
            if vals:
                summary[name] = [min(vals), statistics.median(vals), max(vals)]
        return summary
