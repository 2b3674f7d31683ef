"""Model primitives of the port: ``dense_init`` so far.  Norms, attention
and the rest of ``repro.models.layers`` arrive with the transformer slice."""
from __future__ import annotations

import math

import torch


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               device: torch.device, scale: float | None = None
               ) -> torch.Tensor:
    """Normal init with std ``scale`` (default ``1/sqrt(fan_in)``), drawn
    from ``gen`` on the generator's own device, then placed on ``device``.

    The numbers differ from ``jax.random``'s for the same seed: parity
    tests carry weights across with ``convert.params_from_jax``."""
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * scale
    return x.to(device=device, dtype=dtype)
