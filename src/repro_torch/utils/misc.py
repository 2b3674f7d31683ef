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
