"""The explicit random source of training, and hidden-state dropout.

Every random draw of a training step comes from one `Rng`, handed down from
the trainer: dropout masks and sampled actions from its generator on the
model's device, the per-call attention-dropout seeds from its generator on
the host (drawing one is a host operation, so it costs no device sync).
Passing `rng=None` anywhere turns dropout off, as flax's
`deterministic=True` does.

Under data parallelism (`shard`, parallel/mesh.py) each rank holds one
contiguous block of every global batch, and the draws are those of the
global batch: a draw whose batch dimension holds this rank's rows draws
the global shape from the same generator on every rank and keeps this
rank's rows, and an attention call's dropout bits are keyed by the global
batch row (`row_offset`).  Every rank therefore draws what one process
draws for the whole batch, and at world size 1 every draw is what it is
without a shard.

Under tensor parallelism (parallel/tensor.py) the ranks of the model axis
hold the same rows, and every draw here is of a whole activation, so they
draw the same bits; an attention call on a rank's own heads keys its bits
by the model's head (`head_offset`, models/bert.py:split_attention).  A batch may be `groups` global batches side by side (the
fused rollout's IL and RL halves): each group's rows are then this rank's
block of that group.
"""

from __future__ import annotations

import copy

import torch


class Rng:
    """A device generator and a host generator, both seeded from `seed`, and
    the data-parallel shard whose block of rows this process draws."""

    def __init__(self, seed: int, device, shard=None):
        self.host = torch.Generator().manual_seed(int(seed))
        self.device = torch.Generator(device=torch.device(device)).manual_seed(
            self.seed())
        self.shard = shard
        self.groups = 1

    def seed(self) -> int:
        """A fresh 62-bit seed from the host generator (the same on every
        rank: it draws no batch rows)."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.host))

    def grouped(self, groups: int) -> "Rng":
        """This source, drawing for a batch of `groups` global batches side
        by side; the generators are shared, not copied."""
        out = copy.copy(self)
        out.groups = groups
        return out

    def rand(self, shape, device=None, batch_dim: int = 0) -> torch.Tensor:
        """U[0, 1) of `shape`, whose dim `batch_dim` holds this rank's rows
        (item-major: each item's rows together)."""
        device = self.device.device if device is None else device
        if self.shard is None:
            return torch.rand(shape, generator=self.device, device=device)
        w, g = self.shard.size, self.groups
        shape = list(shape)
        n = shape[batch_dim]
        if n % g:
            raise ValueError(f"{n} rows do not split into {g} groups")
        full = shape.copy()
        full[batch_dim] = n * w
        u = torch.rand(full, generator=self.device, device=device)
        return (u.unflatten(batch_dim, (g, w, n // g))
                .select(batch_dim + 1, self.shard.rank)
                .flatten(batch_dim, batch_dim + 1))

    def row_blocks(self, rows: int) -> list[tuple[int, int, int]]:
        """An attention call over `rows` batch rows as (first local row,
        rows, global row of the first): one block, or one per group."""
        if self.shard is None:
            return [(0, rows, 0)]
        w, r, g = self.shard.size, self.shard.rank, self.groups
        m = rows // g
        return [(i * m, m, (i * w + r) * m) for i in range(g)]


def dropout(x: torch.Tensor, rate: float, rng: Rng | None,
            batch_dim: int = 0) -> torch.Tensor:
    """flax `nn.Dropout`: keep with probability 1 - rate, scale kept values
    by 1 / (1 - rate); the identity without an `rng` or at rate 0.
    `batch_dim` is the dim of `x` that holds the batch rows."""
    if rng is None or rate == 0.0:
        return x
    keep = rng.rand(x.shape, x.device, batch_dim) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
