"""The device mesh and data parallelism.

The port of `vln_imagine_tpu/parallel/mesh.py`.  The reference's only
parallelism is NCCL DistributedDataParallel with per-process env shards
(VLN-HAMT/finetune_src/utils/distributed.py, main.py:130).  The JAX package
runs one global program over a mesh whose 'data' axis splits the batch, so
a step on W devices computes what the one-device step computes on the whole
batch.  The port runs one process per device over `torch.distributed`, and
keeps that equality by hand (`DataShard`):

- each process holds one contiguous block of rows of every global batch
  (`shard_batch`: JAX's P('data') in device order, which here is rank
  order);
- every loss divides by its global denominator (counts and mask sums are
  summed over the ranks, detached), so each rank's loss is its share of the
  global loss; the shares' gradients are summed in one flat all-reduce
  before the clip, so the clip, the update and the optimizer state are the
  same on every rank;
- losses that compare batch items (InfoNCE, margin) see every rank's rows
  through an all-gather that passes gradients back;
- random draws are the global batch's (ops/dropout.py).

The mesh's 'model' axis splits the large parameters (tensor parallelism,
parallel/tensor.py).  The device order is the JAX package's
`reshape(data, model)`: the model axis varies fastest, so the `model`
processes of one data rank are consecutive and hold the same rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from vln_imagine_tpu_torch.parallel.distributed import collective_device


def make_mesh(data: int = -1, model: int = 1, device_type: str | None = None):
    """A DeviceMesh of dims ('data', 'model') over the process group
    (`parallel.distributed.initialize` first), rank d * model + m at
    (d, m); `data=-1` takes every process over `model`.  `device_type`
    defaults to the backend's: 'cuda' under NCCL, else 'cpu'."""
    from torch.distributed.device_mesh import init_device_mesh

    if model < 1:
        raise ValueError(f"a model axis of {model}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize() first")
    n = dist.get_world_size()
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} processes")
    if device_type is None:
        device_type = collective_device().type
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


class _GatherRows(torch.autograd.Function):
    """all_gather along dim 0; the backward sums every rank's gradient of
    the gathered rows and keeps this rank's (what its rows contributed to
    every rank's loss share)."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rank, ctx.rows = group, rank, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        n = ctx.rows
        return grad[ctx.rank * n:(ctx.rank + 1) * n], None, None, None


@dataclasses.dataclass(frozen=True)
class DataShard:
    """This process's place on the mesh's data axis: rank `rank` of `size`
    processes in `group`, holding rows [rank * n, (rank + 1) * n) of every
    global batch of size * n rows."""
    group: Any
    rank: int
    size: int

    @classmethod
    def of(cls, mesh) -> "DataShard":
        group = mesh.get_group("data")
        return cls(group, dist.get_rank(group), dist.get_world_size(group))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of `x`, detached."""
        out = x.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of `x`, in rank order, with autograd."""
        return _GatherRows.apply(x, self.group, self.rank, self.size)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """The data axis' rank 0's `x` on every rank."""
        out = x.detach().clone()
        dist.broadcast(out, dist.get_global_rank(self.group, 0),
                       group=self.group)
        return out

    def all_reduce_grads(self, params) -> None:
        """Sum every gradient over the ranks in one flat f32 bucket.  A
        parameter without a gradient counts as zero, and gets the sum where
        any rank had a gradient for it (one more slot a parameter in the
        bucket), so that every rank's optimizer sees the same gradients."""
        params = [p for p in params]
        if not params:
            return
        dev = params[0].device
        flat = torch.cat(
            [(p.grad if p.grad is not None else torch.zeros_like(p))
             .reshape(-1).float() for p in params]
            + [torch.tensor([float(p.grad is not None) for p in params],
                            device=dev)])
        dist.all_reduce(flat, group=self.group)
        had = flat[-len(params):].tolist()
        chunks = flat[:-len(params)].split([p.numel() for p in params])
        for p, g, n in zip(params, chunks, had):
            if n > 0:
                p.grad = g.view_as(p).to(p.dtype)


def global_sum(x: torch.Tensor, shard: DataShard | None) -> torch.Tensor:
    """`x` summed over the data axis (detached), or `x` itself without a
    shard."""
    return x if shard is None else shard.sum(x)


def _map_tree(fn, tree):
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_tree(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def shard_batch(tree: Any, mesh) -> Any:
    """This rank's contiguous block of rows of every batch-leading array
    (numpy or torch) of `tree` (a dataclass such as EpisodeBatch, a dict, a
    list or tuple, or an array); scalars and None stay as they are."""
    shard = DataShard.of(mesh)

    def rows(x):
        if not isinstance(x, (np.ndarray, torch.Tensor)) or x.ndim == 0:
            return x
        n = x.shape[0]
        if n % shard.size:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{shard.size} processes")
        m = n // shard.size
        return x[shard.rank * m:(shard.rank + 1) * m]

    return _map_tree(rows, tree)


@torch.no_grad()
def replicate(tree: Any, mesh) -> Any:
    """Broadcast, in place, every tensor of `tree` from the data axis' rank
    0: the parameters and buffers of a module, or the tensors of a (nested)
    dict, list or tuple such as an optimizer's `state_dict()`, whose
    tensors are the live ones.  Returns `tree`."""
    group = mesh.get_group("data")
    src = dist.get_global_rank(group, 0)

    def bcast(x):
        if isinstance(x, torch.Tensor):
            buf = x.detach().clone()
            dist.broadcast(buf, src, group=group)
            x.detach().copy_(buf)  # an in-place write: caches see it
        return x

    if isinstance(tree, nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            bcast(t)
        return tree
    _map_tree(bcast, tree)
    return tree
