"""Small helpers shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is wanted but missing — never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    return dev


def uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    """U(-bound, bound) float32 draw on the CPU (the ``*_init`` distribution
    of the JAX package; the numbers differ, the distribution does not)."""
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound
