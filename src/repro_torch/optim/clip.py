"""Global-norm gradient clipping (``repro.optim.clip``)."""
from __future__ import annotations

import torch

from repro_torch.optim.transform import GradientTransform


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def clip_by_global_norm(max_norm: float) -> GradientTransform:
    def init(params):
        return ()

    def update(grads, state, params):
        norm = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
        return {k: (g.float() * scale).to(g.dtype)
                for k, g in grads.items()}, state

    return GradientTransform(init, update)
