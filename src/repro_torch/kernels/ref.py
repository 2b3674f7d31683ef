"""Plain PyTorch versions of the ported kernels (``repro.kernels.ref``).

``ops.*`` runs these for CPU tensors, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def zstats_ref(w: Tensor) -> Tensor:
    """w: (n_blocks, B, r) -> (n_blocks, r, r) fp32 Gram sums."""
    w32 = w.float()
    return torch.einsum("nbi,nbj->nij", w32, w32)


def block_scores_ref(h: Tensor, z: Tensor, cnt: Tensor, alpha: float
                     ) -> Tensor:
    """h: (T, r); z: (N, r, r); cnt: (N,) -> (T, N) kernel masses."""
    h32 = h.float()
    quad = torch.einsum("nij,ti,tj->tn", z.float(), h32, h32)
    return alpha * quad + cnt[None, :]


def leaf_scores_ref(h: Tensor, rows: Tensor, alpha: float) -> Tensor:
    """h: (G, r); rows: (G, B, r) -> (G, B) quadratic-kernel scores."""
    dots = torch.einsum("gbr,gr->gb", rows.float(), h.float())
    return alpha * torch.square(dots) + 1.0


def leaf_dots_ref(h: Tensor, rows: Tensor) -> Tensor:
    """h: (G, r); rows: (G, B, r) -> (G, B) raw dot products (logits)."""
    return torch.einsum("gbr,gr->gb", rows.float(), h.float())
