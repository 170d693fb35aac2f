"""Tensor parallelism over the mesh's 'model' axis.

The port of `vln_imagine_tpu/parallel/mesh.py:param_shardings` and of the
collectives GSPMD inserts for it.  The JAX package places every 2-D
parameter of at least `min_size` elements on 'model', split on its output
axis when the axis size divides it, else on its input axis, and XLA turns
the step into one program whose results are those of the unsharded
program.  The port runs one process per device and keeps that equality by
hand, with plain local tensors and explicit collectives:

- `param_shardings` applies the rule to each parameter's flax shape, found
  through the bridge key map (ckpt/convert.py): a torch `Linear.weight`
  [out, in] is flax's [in, out] kernel, an embedding table is the same in
  both, and DUET's packed `in_proj_weight` [3H, H] is flax's three
  query / key / value kernels, each split on its own;
- `shard_module` replaces each split parameter in place by this rank's
  slice, under its own name, and marks it with its `Split`;
- activations between the split layers are whole on every rank, so every
  rank of the model axis computes the same loss.  A layer whose weight is
  split on its output axis computes its columns from the whole input and
  gathers them (`ModelShard.gather`); one split on its input axis sums its
  partial products (`ModelShard.reduce`).  Its input enters through
  `ModelShard.copy_in`, whose backward sums the ranks' input gradients, so
  every gradient upstream is whole again; a replicated parameter that a
  rank uses only in part (a bias of its local heads, a bias whose dBias
  covers its local heads) enters the same way;
- the attention layers project this rank's columns of q, k and v, which
  are whole heads when the axis divides the heads: each rank runs the
  attention kernels on its own heads (`head_offset` keys their dropout
  bits) and gathers the context (models/bert.py);
- the optimizer's norms sum the squares of split parameters over the axis
  (train/optim.py); checkpoints hold whole tensors (`gather_state`,
  `load_sharded`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from vln_imagine_tpu_torch.ckpt import convert

# the JAX package's default: smaller parameters stay whole on every rank
MIN_SIZE = 2 ** 16
# packed parameters that hold several flax kernels side by side on dim 0
PACKED_BLOCKS = {"in_proj_weight": 3}


def model_axis(mesh) -> int:
    """The size of `mesh`'s 'model' axis (`mesh` may be that size)."""
    if isinstance(mesh, int):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]


def _blocks_view(x: torch.Tensor, dim: int, blocks: int, parts: int):
    """`x` with dim `dim` seen as [blocks, parts, n]."""
    dim = dim % x.dim()
    n = x.shape[dim] // (blocks * parts)
    return x.unflatten(dim, (blocks, parts, n)), dim


class _CopyIn(torch.autograd.Function):
    """The identity; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Gather(torch.autograd.Function):
    """Every rank's `x` joined along `dim` in rank order; the backward
    keeps this rank's part of the (whole, equal on every rank) gradient."""

    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim, ctx.n = shard, dim, x.shape[dim]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(shard.size)]
        dist.all_gather(parts, x.contiguous(), group=shard.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.shard.rank * ctx.n, ctx.n), None, None


class _Reduce(torch.autograd.Function):
    """The sum over the group of each rank's partial `x`, in f32; the
    backward passes the (whole) gradient to every partial."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.float().contiguous()
        if out is x:
            out = out.clone()
        dist.all_reduce(out, group=group)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This process's place on the mesh's model axis: rank `rank` of `size`
    processes in `group`, which all hold the same batch rows."""
    group: Any
    rank: int
    size: int

    @classmethod
    def of(cls, mesh) -> "ModelShard":
        group = mesh.get_group("model")
        return cls(group, dist.get_rank(group), dist.get_world_size(group))

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """`x`, whose gradient is summed over the ranks in the backward."""
        return _CopyIn.apply(x, self.group) if x.requires_grad else x

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's `x` joined along `dim`, with autograd."""
        return _Gather.apply(x, self, dim % x.dim())

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's partial `x`, with autograd."""
        return _Reduce.apply(x, self.group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of `x`, detached."""
        out = x.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def local(self, x: torch.Tensor, dim: int, blocks: int = 1) -> torch.Tensor:
        """This rank's slice of a whole `x` split on `dim` (each of its
        `blocks` blocks split on its own)."""
        v, d = _blocks_view(x, dim, blocks, self.size)
        return v.select(d + 1, self.rank).flatten(d, d + 1)

    @torch.no_grad()
    def whole(self, x: torch.Tensor, dim: int, blocks: int = 1) -> torch.Tensor:
        """The whole tensor of every rank's slice `x`, detached."""
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(self.size)]
        dist.all_gather(parts, x.detach().contiguous(), group=self.group)
        d = dim % x.dim()
        parts = [p.unflatten(d, (blocks, -1)) for p in parts]
        return torch.stack(parts, d + 1).flatten(d, d + 2)


@dataclasses.dataclass(frozen=True)
class Split:
    """How a parameter is split over the model axis: torch dim `dim`, each
    of its `blocks` blocks on its own.  `shard_module` sets it as the
    parameter's `model_split`."""
    shard: ModelShard
    dim: int
    blocks: int = 1

    def local(self, whole: torch.Tensor) -> torch.Tensor:
        return self.shard.local(whole, self.dim, self.blocks)

    def whole(self, local: torch.Tensor) -> torch.Tensor:
        return self.shard.whole(local, self.dim, self.blocks)

    def local_bias(self, bias: torch.Tensor) -> torch.Tensor:
        """This rank's columns of the replicated bias of a weight split on
        its output axis, its gradient summed over the ranks."""
        if self.dim != 0:
            raise ValueError("only a weight split on its output axis has "
                             "local bias columns")
        return self.shard.local(self.shard.copy_in(bias), 0, self.blocks)

    def linear(self, x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None) -> torch.Tensor:
        """`F.linear(x, whole weight, bias)` from this rank's slice of the
        weight and the whole (replicated) `x` and `bias`."""
        s = self.shard
        x = s.copy_in(x)
        if self.dim == 0:
            y = s.gather(F.linear(x, weight), -1)
        else:
            y = s.reduce(F.linear(s.local(x, -1), weight))
        return y if bias is None else y + bias

    def embedding(self, ids: torch.Tensor, weight: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
        """`F.embedding(ids, whole weight).to(dtype)` from this rank's slice
        of the table: its feature columns, or its rows."""
        s = self.shard
        if self.dim == 1:
            return s.gather(F.embedding(ids, weight).to(dtype), -1)
        n = weight.shape[0]
        ids = ids - s.rank * n
        mine = (ids >= 0) & (ids < n)
        rows = F.embedding(ids.clamp(0, n - 1), weight) * mine[..., None]
        return s.reduce(rows).to(dtype)


# ------------------------------------------------------------- the layout
def _flax_path_fn(module: nn.Module):
    """The bridge's torch key -> flax path map of `module`'s type."""
    from vln_imagine_tpu_torch.models.bert import Critic
    from vln_imagine_tpu_torch.models.duet import DuetModel
    from vln_imagine_tpu_torch.models.hamt import HamtModel
    from vln_imagine_tpu_torch.models.vit import VisionTransformer

    for cls, fn in ((HamtModel, convert.hamt_torch_to_flax_path),
                    (DuetModel, convert.duet_torch_to_flax_path),
                    (Critic, convert.critic_torch_to_flax_path),
                    (VisionTransformer, convert.vit_torch_to_flax_path)):
        if isinstance(module, cls):
            return fn
    raise TypeError(f"no flax key map for a {type(module).__name__}")


def _flax_axis(shape: tuple, size: int, min_size: int) -> int | None:
    """The JAX package's rule on a flax shape: the 'model' axis of the
    parameter, or None (replicated)."""
    if len(shape) == 2 and shape[0] * shape[1] >= min_size and size > 1:
        if shape[1] % size == 0:
            return 1
        if shape[0] % size == 0:
            return 0
    return None


def _param_dim(path: str | None, shape: tuple, size: int,
              min_size: int) -> int | None:
    """The torch dim on which a parameter of `shape` at flax `path` is
    split, or None."""
    if path is None or len(shape) != 2:
        return None
    leaf = path.rpartition("/")[2]
    if leaf == "__self_attn.in_proj_weight":  # three [H, H] kernels
        axis = _flax_axis((shape[1], shape[0] // 3), size, min_size)
        return None if axis is None else 1 - axis
    if leaf == "embedding":
        return _flax_axis(tuple(shape), size, min_size)
    if leaf == "weight":  # a Dense kernel, transposed
        axis = _flax_axis((shape[1], shape[0]), size, min_size)
        return None if axis is None else 1 - axis
    return None


def param_shardings(module: nn.Module, mesh,
                    min_size: int | None = None) -> dict[str, int | None]:
    """{parameter name: the torch dim split over 'model', or None} of the
    JAX package's `param_shardings` on `module`'s flax parameters
    (HamtModel, DuetModel, Critic or a ViT).  `mesh` is a mesh or the size
    of its model axis; `min_size` defaults to `MIN_SIZE`."""
    size = model_axis(mesh)
    min_size = MIN_SIZE if min_size is None else min_size
    to_flax = _flax_path_fn(module)
    return {name: _param_dim(to_flax(name), tuple(p.shape), size, min_size)
            for name, p in module.named_parameters()}


@torch.no_grad()
def shard_module(module: nn.Module, shard: ModelShard,
                 specs: dict[str, int | None]) -> nn.Module:
    """Replace each parameter that `specs` splits by this rank's slice of
    it, under its own name, marked with its `Split` (`model_split`).
    Returns `module`."""
    for name, dim in specs.items():
        if dim is None:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        whole = getattr(owner, leaf)
        split = Split(shard, dim, PACKED_BLOCKS.get(leaf, 1))
        local = nn.Parameter(split.local(whole).clone(
            memory_format=torch.contiguous_format),
            requires_grad=whole.requires_grad)
        local.model_split = split
        setattr(owner, leaf, local)
    return module


def shard_model(module: nn.Module, mesh) -> nn.Module:
    """`module` split over `mesh`'s model axis by `param_shardings`; as it
    is at a model axis of 1."""
    if model_axis(mesh) > 1:
        shard_module(module, ModelShard.of(mesh), param_shardings(module, mesh))
    return module


def split_of(p: torch.Tensor) -> Split | None:
    """How `p` is split over the model axis, or None where it is whole."""
    return getattr(p, "model_split", None)


# ------------------------------------------------------------ whole state
def _map_optimizer_state(optimizer, state: dict, fn) -> dict:
    """A `GroupedOptimizer.state_dict()`-layout `state` with `fn(tensor,
    parameter)` applied to every moment and Lookahead slow weight, in
    parameter order."""
    groups = []
    for group, g_state in zip(optimizer.groups, state["groups"]):
        groups.append({k: v if k == "count" else
                       {i: fn(t, group.params[i]) for i, t in sorted(v.items())}
                       for k, v in g_state.items()})
    out = dict(state, groups=groups)
    if "lookahead" in state:
        params = optimizer.params()
        la = state["lookahead"]
        out["lookahead"] = dict(la, slow={
            i: fn(t, params[i]) for i, t in sorted(la["slow"].items())})
    return out


def _module_tensors(module: nn.Module, state: dict, fn) -> dict:
    params = dict(module.named_parameters())
    return {k: fn(v, params[k]) if k in params else v
            for k, v in state.items()}


def gather_state(obj) -> dict:
    """The whole `state_dict()` of a module or a `GroupedOptimizer` whose
    parameters may be split: each split tensor gathered over the model
    axis (a collective: every rank of the axis calls it), the others the
    live ones."""
    def whole(t, p):
        split = split_of(p)
        return t if split is None else split.whole(t)

    if isinstance(obj, nn.Module):
        return _module_tensors(obj, obj.state_dict(), whole)
    return _map_optimizer_state(obj, obj.state_dict(), whole)


def load_sharded(obj, state: dict) -> None:
    """`obj.load_state_dict` of a whole `state` (`gather_state`'s layout),
    each split tensor cut to this rank's slice first."""
    def local(t, p):
        split = split_of(p)
        return t if split is None else split.local(t)

    if isinstance(obj, nn.Module):
        obj.load_state_dict(_module_tensors(obj, state, local))
    else:
        obj.load_state_dict(_map_optimizer_state(obj, state, local))
