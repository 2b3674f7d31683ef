"""Global-norm gradient clipping (``repro.optim.clip``).

``update`` writes the clipped gradients into the dict it is given, entry
by entry, and returns that dict: a caller that hands over its only
references (the train step) holds one clipped copy of one tensor at a
time, not a second copy of every gradient."""
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
        for k, g in grads.items():
            grads[k] = (g.float() * scale).to(g.dtype)
        return grads, state

    return GradientTransform(init, update)
