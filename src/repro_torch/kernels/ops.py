"""Public wrappers of the ported kernels (``repro.kernels.ops``).

Dispatch is by the tensors' device, as the reference's is by backend: a
CUDA tensor goes to the hand-written CUDA kernel (a failure raises — there
is no fallback), a CPU tensor to the plain PyTorch version in ``ref``.
The CUDA kernels mask their ragged edges themselves, so the reference's
tile padding (``ops.py:36-43`` there) has no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.block_scores import block_scores as _block_scores
from repro_torch.kernels.leaf_scores import leaf_scores as _leaf_scores
from repro_torch.kernels.zstats import zstats as _zstats

Tensor = torch.Tensor


def _on_cuda(*ts: Tensor) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on unsupported or mixed devices: "
                     f"{[str(t.device) for t in ts]}")


def zstats(w: Tensor) -> Tensor:
    """w: (n_blocks, B, r) -> (n_blocks, r, r) fp32 block Grams."""
    if _on_cuda(w):
        return _zstats(w.contiguous())
    return ref.zstats_ref(w)


def block_scores(h: Tensor, z: Tensor, cnt: Tensor,
                 alpha: float = 100.0) -> Tensor:
    """h: (T, r); z: (N, r, r); cnt: (N,) -> (T, N) kernel masses."""
    if _on_cuda(h, z, cnt):
        return _block_scores(h.contiguous(), z.contiguous(),
                             cnt.contiguous(), alpha=alpha)
    return ref.block_scores_ref(h, z, cnt, alpha)


def leaf_scores(h: Tensor, rows: Tensor, alpha: float = 100.0) -> Tensor:
    """h: (G, r); rows: (G, B, r) -> (G, B) quadratic-kernel scores."""
    if _on_cuda(h, rows):
        return _leaf_scores(h.contiguous(), rows.contiguous(), alpha=alpha,
                            square=True)
    return ref.leaf_scores_ref(h, rows, alpha)


def leaf_dots(h: Tensor, rows: Tensor) -> Tensor:
    """h: (G, r); rows: (G, B, r) -> (G, B) raw dots <h_g, w_{g,b}>.

    The exact-scoring step of serving-side beam retrieval: the same kernel
    as ``leaf_scores``, without the kernelization."""
    if _on_cuda(h, rows):
        return _leaf_scores(h.contiguous(), rows.contiguous(), alpha=0.0,
                            square=False)
    return ref.leaf_dots_ref(h, rows)
