"""SGD with (Nesterov-free) momentum (``repro.optim.sgd``)."""
from __future__ import annotations

import torch

from repro_torch.optim.transform import GradientTransform


def sgd(lr, momentum: float = 0.0) -> GradientTransform:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        mom = ({k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()} if momentum else None)
        device = next(iter(params.values())).device
        return {"mom": mom,
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if momentum:
            mom = {k: momentum * state["mom"][k] + g.float()
                   for k, g in grads.items()}
            upd = {k: -lr_t * v for k, v in mom.items()}
        else:
            mom = None
            upd = {k: -lr_t * g.float() for k, g in grads.items()}
        return upd, {"mom": mom, "step": step}

    return GradientTransform(init, update)
