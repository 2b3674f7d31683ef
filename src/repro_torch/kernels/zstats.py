"""CUDA kernel wrapper: per-block Gram matrices  Z_b = W_b^T W_b.

Counterpart of ``repro.kernels.zstats`` (a Pallas kernel); the kernel is
``csrc/zstats.cu``: register-tiled fp32, upper-triangle tiles only, each
off-diagonal tile written twice.  ``launches`` counts the kernel's
launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0

#: the kernel's output tile edge by width: 128 x 128 tiles (8 x 8 per
#: thread) from r = WIDE_TILE_MIN_R on, 64 x 64 (4 x 4) below it, where
#: they measured faster on an H100 (r = 128 to 512: more blocks per SM)
WIDE_TILE_MIN_R = 1024


def tile_for(r: int) -> int:
    """The output tile edge the kernel runs at width ``r``."""
    return 128 if r >= WIDE_TILE_MIN_R else 64


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
                  tile_for(r), w.device.index, stream)
    launches += 1
    return z
