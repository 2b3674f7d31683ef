"""Generic helpers used across the port."""
from __future__ import annotations

import math

import torch


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (x >= 1)."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def log2_int(x: int) -> int:
    if x <= 0 or x & (x - 1):
        raise ValueError(f"{x} is not a power of two")
    return int(math.log2(x))


def fold_in(seed: int, i: int) -> int:
    """A generator seed derived from (seed, i), distinct for every pair
    with 0 <= i < 2**31 — the port's counterpart of
    ``jax.random.fold_in(PRNGKey(seed), i)``."""
    return (seed * 0x9E3779B1 + i) % (1 << 62)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point creates its tensors on.

    ``None`` means the card; without CUDA that raises instead of quietly
    running on the CPU (pass ``device="cpu"`` to ask for the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the "
                "CPU")
        return torch.device("cuda")
    return torch.device(device)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: (values, indices), descending, ties
    broken by the LOWEST index (``torch.topk`` promises no tie order; the
    serving contract is "lowest class id wins", and the -inf bounds of empty
    nodes tie often).  A stable descending sort keeps equal values in index
    order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def fold_generator(gen: torch.Generator, i: int) -> torch.Generator:
    """A fresh generator on ``gen``'s device seeded from (``gen``'s seed,
    i): the counterpart of ``jax.random.fold_in(key, i)`` on a step's
    key.  A pure function of the seed ``gen`` was made with, like a JAX
    key, whatever ``gen`` has drawn since."""
    return torch.Generator(gen.device).manual_seed(
        fold_in(gen.initial_seed(), i))
