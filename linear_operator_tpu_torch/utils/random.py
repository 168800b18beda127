"""Seeded normal draws (the port's counterpart of the JAX package's explicit
PRNG keys)."""

from __future__ import annotations

import torch


def randn(shape, dtype: torch.dtype, device, generator: torch.Generator | None) -> torch.Tensor:
    """N(0, I) of ``shape`` drawn on the generator's own device and moved to
    ``device``, so that one seed gives the same numbers on the CPU and the
    card; without a generator, a fixed CPU one (seed 0), as the JAX package
    falls back to a fixed key."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.randn(tuple(shape), dtype=dtype, device=generator.device, generator=generator).to(device)
