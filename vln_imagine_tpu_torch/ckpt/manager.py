"""Checkpoint persistence with the reference's retention policy.

Reference behaviour (VLN-HAMT/finetune_src/r2r/main.py:347-359,
agent_cmt.py:837-875): `best_<env>` whenever spl+sr improves (DUET: spl,
main_nav.py:347-351), `latest_dict` every interval, and a full snapshot every
2000 iters under all_ckpts/iter_<i>_SR_<sr>_SPL_<spl>_<env>; checkpoints
bundle {model, critic} x {epoch, state_dict, optimizer}.

The port of `vln_imagine_tpu/ckpt/manager.py`: one `torch.save` file per save
slot, with the slot names and the policy of the JAX package.  A slot holds
whatever state the caller hands it (the driver's is the reference's
agent-save layout, so `load_reference_checkpoint` reads the port's own
`best_*` files too).  `load_reference_checkpoint` / `load_reference_pretrain`
read the released torch files: the port's modules carry the reference's key
names, so these only strip the `module.` / `vln_bert.` / `bert.` prefixes.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any

import torch

from vln_imagine_tpu_torch.ckpt.convert import (
    critic_torch_to_flax_path,
    duet_torch_to_flax_path,
    hamt_torch_to_flax_path,
    strip_reference_prefixes,
)


class CheckpointManager:
    def __init__(self, ckpt_dir: str, select_metric: str = "spl_sr"):
        """select_metric: 'spl_sr' (HAMT, main.py:352) or 'spl'
        (DUET, main_nav.py:347)."""
        self.dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.select_metric = select_metric
        self.best_score: dict[str, float] = {}
        # one record per save and load: slot, host seconds, file bytes
        self.events: list[dict] = []

    # ------------------------------------------------------------------ save
    def _save(self, name: str, state: Any):
        path = os.path.join(self.dir, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        t0 = time.perf_counter()
        # write then rename: a crash mid-save leaves the previous slot intact
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        self.events.append({"op": "save", "name": name,
                            "seconds": time.perf_counter() - t0,
                            "bytes": os.path.getsize(path)})

    def save_latest(self, state: Any):
        self._save("latest_dict", state)

    def save_snapshot(self, state: Any, iteration: int, sr: float, spl: float,
                      env_name: str):
        self._save(
            f"all_ckpts/iter_{iteration}_SR_{sr:.2f}_SPL_{spl:.2f}_{env_name}",
            state)

    def maybe_save_best(self, state: Any, env_name: str,
                        metrics: dict) -> bool:
        score = (metrics["spl"] + metrics["sr"]
                 if self.select_metric == "spl_sr" else metrics["spl"])
        if score >= self.best_score.get(env_name, float("-inf")):
            self.best_score[env_name] = score
            self._save(f"best_{env_name}", state)
            with open(os.path.join(self.dir, f"best_{env_name}.json"),
                      "w") as f:
                json.dump(metrics, f)
            return True
        return False

    # ------------------------------------------------------------------ load
    def load(self, name: str, example_state: Any = None,
             map_location=None) -> Any:
        """The state saved under `name` (a slot name or a path).  With
        `example_state`, every tensor of the saved state's `state_dict`
        subtrees must have a counterpart of the same shape there and back:
        a mismatch means the checkpoint belongs to a differently
        configured model."""
        path = os.path.join(self.dir, name)
        t0 = time.perf_counter()
        restored = torch.load(path, map_location=map_location,
                              weights_only=True)
        self.events.append({"op": "load", "name": name,
                            "seconds": time.perf_counter() - t0,
                            "bytes": os.path.getsize(path)})
        if example_state is not None:
            want, got = _model_shapes(example_state), _model_shapes(restored)
            if want != got:
                diff = sorted(set(want.items()) ^ set(got.items()))[:8]
                raise ValueError(
                    f"checkpoint '{name}' has {len(got)} model tensors, "
                    f"expected {len(want)} — it was saved from a "
                    f"differently configured model (first differences: "
                    f"{diff})")
        return restored

    def list_snapshots(self) -> list[str]:
        root = os.path.join(self.dir, "all_ckpts")
        if not os.path.isdir(root):
            return []
        return sorted(os.listdir(root))

    def best_iteration(self, env_name: str) -> str | None:
        """Parse the iteration out of snapshot names like the released
        `iter_32000_SR_67.26_SPL_62.02_val_unseen`."""
        best, best_score = None, float("-inf")
        for name in self.list_snapshots():
            m = re.match(r"iter_(\d+)_SR_([\d.]+)_SPL_([\d.]+)_" + env_name,
                         name)
            if m:
                score = float(m.group(2)) + float(m.group(3))
                if score > best_score:
                    best, best_score = name, score
        return best


def _model_shapes(state: Any, prefix: str = "") -> dict[str, tuple]:
    """{path: shape} of every tensor under a `state_dict` key of `state`."""
    out: dict[str, tuple] = {}
    if isinstance(state, dict):
        for k, v in state.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            if k == "state_dict" and isinstance(v, dict):
                out.update({f"{path}/{n}": tuple(t.shape)
                            for n, t in v.items() if torch.is_tensor(t)})
            else:
                out.update(_model_shapes(v, path))
    return out


_KEY_MAPS = {"hamt": hamt_torch_to_flax_path, "duet": duet_torch_to_flax_path}


def load_reference_checkpoint(path: str, agent: str = "hamt") -> dict:
    """A released torch checkpoint ({vln_bert, critic} x {epoch, state_dict,
    optimizer}, agent_cmt.py:837-852) -> {'state_dict': the navigator's
    state_dict with the port's keys, 'critic_state_dict' (when saved),
    'epoch', 'skipped': the keys the reference's models hold but the
    fine-tune models do not (unused heads, the BERT pooler)}."""
    states = torch.load(path, map_location="cpu", weights_only=True)
    out: dict = {}
    if "vln_bert" in states:
        sd = strip_reference_prefixes(states["vln_bert"]["state_dict"])
        out["skipped"] = [k for k in sd if _KEY_MAPS[agent](k) is None]
        out["state_dict"] = {k: v for k, v in sd.items()
                             if k not in out["skipped"]}
        out["epoch"] = states["vln_bert"].get("epoch")
    if "critic" in states:
        csd = strip_reference_prefixes(states["critic"]["state_dict"])
        out["critic_state_dict"] = {
            k: v for k, v in csd.items() if critic_torch_to_flax_path(k)}
    return out


def load_reference_pretrain(path: str, agent: str = "hamt") -> dict:
    """A released torch PRE-TRAIN checkpoint (the flat model_step_<N>.pt
    state_dict ModelSaver writes, pretrain_src/utils/save.py:23-46 — the
    file the reference feeds to --bert_ckpt_file, vlnbert_init.py:20-31) ->
    {'state_dict': its tensors under the port's keys, 'skipped': keys no
    fine-tune or pre-train module maps (pretrain-only heads)}.  The
    fine-tune-only modules are absent; graft with
    ckpt.transfer.init_finetune_from_pretrain."""
    states = torch.load(path, map_location="cpu", weights_only=True)
    if "vln_bert" in states:
        raise ValueError(f"'{path}' is an agent-save checkpoint; use "
                         "load_reference_checkpoint for it")
    sd = strip_reference_prefixes(states)
    skipped = [k for k in sd if _KEY_MAPS[agent](k) is None]
    return {"state_dict": {k: v for k, v in sd.items() if k not in skipped},
            "skipped": skipped}
