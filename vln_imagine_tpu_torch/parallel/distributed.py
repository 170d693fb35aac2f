"""Multi-process utilities over `torch.distributed`.

The port of `vln_imagine_tpu/parallel/distributed.py`, itself a rebuild of
VLN-HAMT/finetune_src/utils/distributed.py: the reference's process group
with file:// rendezvous, the pickled all_gather of python objects
(:90-130), reduce_dict (:133-157) and merge_dist_results (:160).  One
process drives one device: NCCL for a CUDA device, gloo for the CPU.  With
one process and no group, every function does what the JAX package's does
at `process_count() == 1`.
"""

from __future__ import annotations

import os
import pickle
from datetime import timedelta
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from vln_imagine_tpu_torch.platform import resolve_device


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device=None, backend: str | None = None,
               timeout: float = 600.0) -> torch.device:
    """Join the process group and return this process's device.

    Under torchrun (RANK / WORLD_SIZE / LOCAL_RANK set) the rendezvous is
    `env://` unless `init_method` names one; without a launcher and without
    `init_method`, a one-process group starts on an in-process store.  The
    device is `resolve_device(device)`, and a CUDA device without an index
    takes LOCAL_RANK's (or the rank's) card.  The backend is NCCL for a
    CUDA device and gloo otherwise, unless `backend` names one.  A
    collective that waits past `timeout` seconds fails instead of hanging.
    Calling it again once the group exists only resolves the device."""
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"]) if launched else 1
    if rank is None:
        rank = int(os.environ["RANK"]) if launched else 0
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    kw = dict(backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
              world_size=world_size, rank=rank,
              timeout=timedelta(seconds=timeout))
    if init_method is None and not launched:
        if world_size != 1:
            raise ValueError(f"{world_size} processes need an init_method "
                             "(file://... or tcp://host:port) or a launcher")
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = init_method or "env://"
    dist.init_process_group(**kw)
    return dev


def process_count(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def process_index(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_default_process() -> bool:
    """is_default_gpu (distributed.py:74-78): the process that writes."""
    return process_index() == 0


def shard_indices(n: int, process_id: int | None = None,
                  num_processes: int | None = None) -> slice:
    """Per-process dataset shard (sel_data_idxs, main.py:130 /
    env.py:135-143): contiguous split with the last process absorbing the
    remainder."""
    p = process_index() if process_id is None else process_id
    w = process_count() if num_processes is None else num_processes
    per = n // w
    start = per * p
    end = None if p == w - 1 else start + per
    return slice(start, end)


def _encode_payload(obj: Any) -> np.ndarray:
    """pickle -> uint8 vector (the reference's ByteTensor encoding,
    distributed.py:96-103)."""
    return np.frombuffer(pickle.dumps(obj), np.uint8)


def _pad_payload(payload: np.ndarray, max_size: int) -> np.ndarray:
    padded = np.zeros(max_size, np.uint8)
    padded[: payload.size] = payload
    return padded


def _decode_payloads(gathered: np.ndarray, sizes: np.ndarray) -> list[Any]:
    """[W, max_size] padded byte rows + per-row sizes -> objects
    (distributed.py:120-130)."""
    return [pickle.loads(gathered[i, : int(sizes[i])].tobytes())
            for i in range(len(sizes))]


def collective_device(group=None) -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    parts = [torch.empty_like(t) for _ in range(process_count(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def all_gather_objects(obj: Any, group=None) -> list[Any]:
    """Every process's picklable `obj`, in rank order (distributed.py:
    90-130: pickle -> sizes -> padded byte tensors -> all_gather ->
    decode).  The byte path also runs for one process, so it is exercised
    on every call."""
    payload = _encode_payload(obj)
    if process_count(group) == 1:
        sizes = np.asarray([payload.size], np.int64)
        return _decode_payloads(_pad_payload(payload, payload.size)[None, :],
                                sizes)
    dev = collective_device(group)
    size = torch.tensor([payload.size], dtype=torch.int64, device=dev)
    sizes = np.asarray([int(s) for s in _all_gather(size, group)])
    padded = torch.from_numpy(_pad_payload(payload, int(sizes.max()))).to(dev)
    gathered = np.stack([p.cpu().numpy() for p in _all_gather(padded, group)])
    return _decode_payloads(gathered, sizes)


def merge_results(results_per_host: Sequence[Sequence[dict]],
                  key: str = "instr_id") -> list[dict]:
    """merge_dist_results (distributed.py:160-166) with de-duplication by
    `key` (processes may overlap on the wrapped tail of eval shards)."""
    seen = set()
    out = []
    for host_results in results_per_host:
        for item in host_results:
            k = item.get(key)
            if k in seen:
                continue
            seen.add(k)
            out.append(item)
    return out


def reduce_dict(metrics: dict[str, float], average: bool = True,
                group=None) -> dict[str, float]:
    """Cross-process scalar reduction in f32 (distributed.py:133-157):
    the mean over processes, or with `average=False` the sum."""
    if process_count(group) == 1:
        return dict(metrics)
    keys = sorted(metrics)
    vals = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float32,
                        device=collective_device(group))
    dist.all_reduce(vals, group=group)
    if average:
        vals = vals / process_count(group)
    return dict(zip(keys, vals.cpu().tolist()))
