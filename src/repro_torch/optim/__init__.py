"""Optimizers of the port (``repro.optim``): clip, AdamW, Adafactor, SGD,
schedules.

Gradient compression (``bf16_compress``, ``topk_error_feedback``) arrives
with the multi-device slice (ROADMAP.md A17)."""
from repro_torch.optim.transform import GradientTransform, chain  # noqa: F401
from repro_torch.optim.adafactor import adafactor  # noqa: F401
from repro_torch.optim.adamw import adamw  # noqa: F401
from repro_torch.optim.sgd import sgd  # noqa: F401
from repro_torch.optim.clip import clip_by_global_norm  # noqa: F401
from repro_torch.optim.schedule import (  # noqa: F401
    constant_schedule,
    cosine_schedule,
)


def make_optimizer(name: str, lr, **kw) -> GradientTransform:
    """Build the standard production stack: clip -> optimizer."""
    opts = {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}
    if name not in opts:
        raise KeyError(f"unknown optimizer '{name}'; have {sorted(opts)}")
    return chain(clip_by_global_norm(1.0), opts[name](lr, **kw))
