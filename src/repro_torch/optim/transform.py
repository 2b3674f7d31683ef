"""Minimal optax-style gradient transformations over dicts of tensors
(``repro.optim.transform``).

Parameters, gradients and updates are flat ``{name: tensor}`` dicts (a
module's ``named_parameters()``).  ``apply_updates`` adds in place: the
reference returns new arrays, the port reuses the parameters' memory."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Params = dict[str, torch.Tensor]
State = Any
Updates = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GradientTransform:
    init: Callable[[Params], State]
    update: Callable[[Updates, State, Params], tuple[Updates, State]]


def chain(*transforms: GradientTransform) -> GradientTransform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s2 = t.update(grads, s, params)
            new_state.append(s2)
        return grads, tuple(new_state)

    return GradientTransform(init, update)


@torch.no_grad()
def apply_updates(params: Params, updates: Updates) -> Params:
    """p += u for every parameter, in place; returns ``params``."""
    for name, p in params.items():
        u = updates.get(name)
        if u is not None:
            p.add_(u.to(p.dtype))
    return params
