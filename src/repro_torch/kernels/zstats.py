"""CUDA kernel wrapper: per-block Gram matrices  Z_b = W_b^T W_b.

Counterpart of ``repro.kernels.zstats`` (a Pallas kernel); the kernel is
``csrc/zstats.cu``.  ``launches`` counts the kernel's launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0


def zstats(w: torch.Tensor) -> torch.Tensor:
    """w: (n_blocks, B, r) fp32 CUDA -> (n_blocks, r, r) fp32."""
    global launches
    _build.check("w", w, 3)
    n_blocks, rows, r = w.shape
    z = torch.empty((n_blocks, r, r), dtype=torch.float32, device=w.device)
    if z.numel() == 0:
        return z
    stream = torch.cuda.current_stream(w.device).cuda_stream
    _build.launch("zstats", w.data_ptr(), z.data_ptr(), n_blocks, rows, r,
                  w.device.index, stream)
    launches += 1
    return z
