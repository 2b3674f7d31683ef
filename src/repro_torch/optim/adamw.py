"""AdamW with fp32 moments (``repro.optim.adamw``).

The reference's defaults (b2 = 0.95, weight decay 0.1), not
``torch.optim.AdamW``'s (0.999, 0.01).  The bias corrections use
``b ** step`` in fp32 tensors, as the reference does, so nothing syncs with
the host.

``update`` writes the moments IN PLACE and returns the same dicts (the
reference returns new arrays): a second copy of the fp32 moments would
not fit beside a 3B-parameter model's (25 GB) on one card.  The values
are the reference's, operation for operation; a caller that keeps an
earlier state sees it updated."""
from __future__ import annotations

import torch

from repro_torch.optim.transform import GradientTransform


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> GradientTransform:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        device = next(iter(params.values())).device
        return {"m": zeros,
                "v": {k: z.clone() for k, z in zeros.items()},
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        s32 = step.float()
        c1 = 1.0 - torch.pow(torch.tensor(b1, device=s32.device), s32)
        c2 = 1.0 - torch.pow(torch.tensor(b2, device=s32.device), s32)
        m, v = state["m"], state["v"]
        upd = {}
        for k, g in grads.items():  # one parameter's temporaries at a time
            g32 = g.float()
            m[k].mul_(b1).add_((1 - b1) * g32)
            v[k].mul_(b2).add_((1 - b2) * torch.square(g32))
            upd[k] = -lr_t * ((m[k] / c1) / (torch.sqrt(v[k] / c2) + eps)
                              + weight_decay * params[k].detach().float())
        return upd, {"m": m, "v": v, "step": step}

    return GradientTransform(init, update)
