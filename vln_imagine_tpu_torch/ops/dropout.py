"""The explicit random source of training, and hidden-state dropout.

Every random draw of a training step comes from one `Rng`, handed down from
the trainer: dropout masks and sampled actions from its generator on the
model's device, the per-call attention-dropout seeds from its generator on
the host (drawing one is a host operation, so it costs no device sync).
Passing `rng=None` anywhere turns dropout off, as flax's
`deterministic=True` does.
"""

from __future__ import annotations

import torch


class Rng:
    """A device generator and a host generator, both seeded from `seed`."""

    def __init__(self, seed: int, device):
        self.host = torch.Generator().manual_seed(int(seed))
        self.device = torch.Generator(device=torch.device(device)).manual_seed(
            self.seed())

    def seed(self) -> int:
        """A fresh 62-bit seed from the host generator."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.host))


def dropout(x: torch.Tensor, rate: float, rng: Rng | None) -> torch.Tensor:
    """flax `nn.Dropout`: keep with probability 1 - rate, scale kept values
    by 1 / (1 - rate); the identity without an `rng` or at rate 0."""
    if rng is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=rng.device, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
