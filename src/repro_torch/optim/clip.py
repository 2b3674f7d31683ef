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
    """A mesh rank's gradients: ``specs[name]`` is the leaf's spec (one
    entry a dim: None, a mesh axis or a tuple of them; its gradient is
    alike on the ranks along every axis it does not name), ``ctx`` the
    rank's ``ShardCtx``.  ``global_norm`` sums each leaf's squares over
    exactly the axes that shard it, so every rank clips by the norm of the
    whole model and a leaf replicated over an axis counts once; Adafactor
    takes its means over a dim the same way (``dim_axes``)."""

    def __init__(self, grads: dict[str, torch.Tensor], specs: dict, ctx):
        super().__init__(grads)
        self.specs = {k: tuple(specs[k]) for k in grads}
        self.ctx = ctx

    def dim_axes(self, name: str, dim: int) -> tuple[str, ...]:
        """The axes of more than one rank that shard dim ``dim`` of the
        leaf ``name``, in the mesh's order."""
        entry = self.specs[name][dim]
        named = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        return tuple(a for a in self.ctx.mesh.mesh_dim_names
                     if a in named and self.ctx.axis_size(a) > 1)

    def leaf_axes(self, name: str) -> tuple[str, ...]:
        """Every axis of more than one rank that shards the leaf."""
        axes = {a for d in range(len(self.specs[name]))
                for a in self.dim_axes(name, d)}
        return tuple(a for a in self.ctx.mesh.mesh_dim_names if a in axes)

    def psum(self, x: torch.Tensor, axes: tuple[str, ...]) -> torch.Tensor:
        """``x`` summed over ``axes`` (as ``dim_axes`` gives them)."""
        if not axes:
            return x
        from repro_torch.core import distributed

        return distributed.psum(x, self.ctx.group(axes))

    def size(self, axes: tuple[str, ...]) -> int:
        return self.ctx.axis_size(axes)


def _sum_squares(xs) -> torch.Tensor:
    return sum(torch.sum(torch.square(p.float()))
               for x in xs for p in _pieces(x))


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    if not isinstance(tree, ShardedGrads):
        return torch.sqrt(_sum_squares(tree.values()))
    by_axes: dict[tuple[str, ...], list[torch.Tensor]] = {}
    for k, x in tree.items():
        by_axes.setdefault(tree.leaf_axes(k), []).append(x)
    return torch.sqrt(sum(tree.psum(_sum_squares(xs), axes)
                          for axes, xs in sorted(by_axes.items())))


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
