"""Device choice shared by the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """The entry points run on the card unless the caller names a device:
    under a launcher that sets LOCAL_RANK (torchrun), the card of that
    index.

    With no device given and no CUDA, this raises: nothing falls back to the
    CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        local_rank = os.environ.get("LOCAL_RANK")
        return (torch.device("cuda") if local_rank is None
                else torch.device("cuda", int(local_rank)))
    return torch.device(device)
