"""Global-norm gradient clipping (``repro.optim.clip``).

``update`` scales the gradients it is given IN PLACE, piece by piece, and
returns the same dict: a caller that hands over its only references (the
train step) holds no second copy of any gradient, and no gradient is
ever cast to fp32 whole (one MoE layer's 256 bf16 expert stacks of
deepseek-v3-671b are 7.5 GB, 15 GB in fp32).  Each element is scaled as
the reference scales it, in fp32 and rounded back to its dtype; the
squares are summed in fp32, a piece at a time."""
from __future__ import annotations

import torch

from repro_torch.optim import transform
from repro_torch.optim.transform import GradientTransform


def _pieces(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Views of a contiguous x's elements, ``transform.PIECE`` at a
    time."""
    return x.view(-1).split(transform.PIECE)


class ShardedGrads(dict):
    """A mesh rank's gradients: the names in ``sharded`` are its shard of
    a table split over ``group`` (the head's vocab rows), the rest are
    whole and alike on the group's ranks.  ``global_norm`` sums the
    shards' squares over the group, so every rank clips by the norm of the
    whole model."""

    def __init__(self, grads: dict[str, torch.Tensor], sharded, group):
        super().__init__(grads)
        self.sharded = frozenset(sharded)
        self.group = group


def _sum_squares(xs) -> torch.Tensor:
    return sum(torch.sum(torch.square(p.float()))
               for x in xs for p in _pieces(x))


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    sharded = getattr(tree, "sharded", frozenset())
    if not sharded:
        return torch.sqrt(_sum_squares(tree.values()))
    from repro_torch.core import distributed

    own = _sum_squares(x for k, x in tree.items() if k in sharded)
    whole = _sum_squares(x for k, x in tree.items() if k not in sharded)
    return torch.sqrt(whole + distributed.psum(own, tree.group))


def clip_by_global_norm(max_norm: float) -> GradientTransform:
    def init(params):
        return ()

    def update(grads, state, params):
        """Consumes ``grads``: each (contiguous) gradient is scaled in
        place, and the same dict is returned.  A caller that still needs
        its gradients passes copies."""
        norm = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
        for g in grads.values():
            for p in _pieces(g):
                p.copy_(p.float() * scale)
        return grads, state

    return GradientTransform(init, update)
