"""Optimizers of the port (``repro.optim``): clip, AdamW, SGD, schedules.

``adafactor`` and gradient compression arrive with ROADMAP.md A17."""
from repro_torch.optim.transform import GradientTransform, chain  # noqa: F401
from repro_torch.optim.adamw import adamw  # noqa: F401
from repro_torch.optim.sgd import sgd  # noqa: F401
from repro_torch.optim.clip import clip_by_global_norm  # noqa: F401
from repro_torch.optim.schedule import (  # noqa: F401
    constant_schedule,
    cosine_schedule,
)


def make_optimizer(name: str, lr, **kw) -> GradientTransform:
    """Build the standard production stack: clip -> optimizer."""
    if name == "adafactor":
        raise NotImplementedError(
            "adafactor is not ported yet (ROADMAP.md A17)")
    opts = {"adamw": adamw, "sgd": sgd}
    if name not in opts:
        raise KeyError(f"unknown optimizer '{name}'; have "
                       f"{sorted(opts) + ['adafactor']}")
    return chain(clip_by_global_norm(1.0), opts[name](lr, **kw))
