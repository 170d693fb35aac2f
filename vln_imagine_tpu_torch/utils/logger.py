"""Logging utilities.

Rebuild of the reference observability surface: record-file writer
(VLN-HAMT/finetune_src/utils/logger.py:8-25), smoothed RunningMeter + LOGGER
(pretrain_src/utils/logger.py:20-94), training-args dump (main.py:142-143).
TensorBoard scalars are written as JSONL (tensorboardX is not a dependency);
each record is trivially importable into TB or any plotting stack.  The
port's own copy of the JAX package's module.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


def write_to_record_file(data: str, path: str, verbose: bool = True):
    if verbose:
        print(data)
    with open(path, "a") as f:
        f.write(data + "\n")


class RunningMeter:
    """Exponentially smoothed scalar (pretrain_src/utils/logger.py:62-94)."""

    def __init__(self, name: str, val: float | None = None,
                 smooth: float = 0.99):
        self.name = name
        self.smooth = smooth
        self._val = val

    def __call__(self, value: float):
        self._val = value if self._val is None else (
            self._val * self.smooth + value * (1 - self.smooth))

    @property
    def val(self) -> float | None:
        return self._val


class MetricsWriter:
    """Append-only JSONL scalar log (stand-in for tensorboardX scalars)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")

    def add_scalar(self, tag: str, value: float, step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": int(step), "time": time.time()}) + "\n")

    def add_scalars(self, scalars: dict[str, float], step: int,
                    prefix: str = ""):
        for k, v in scalars.items():
            self.add_scalar(prefix + k if not prefix or prefix.endswith("/")
                            else f"{prefix}/{k}", v, step)


def dump_args(args: Any, log_dir: str, name: str = "training_args.json"):
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, name), "w") as f:
        if hasattr(args, "__dataclass_fields__"):
            import dataclasses
            json.dump(dataclasses.asdict(args), f, indent=2, default=str)
        else:
            json.dump(vars(args) if hasattr(args, "__dict__") else args, f,
                      indent=2, default=str)


def print_progress(iteration: int, total: int, prefix: str = "",
                   suffix: str = "", bar_length: int = 50):
    """Terminal progress bar (utils/logger.py:60-80)."""
    frac = iteration / max(total, 1)
    filled = int(round(bar_length * frac))
    bar = "#" * filled + "-" * (bar_length - filled)
    print(f"\r{prefix} |{bar}| {100 * frac:.1f}% {suffix}", end="",
          flush=True)
    if iteration >= total:
        print()
