"""CUDA kernel wrapper: batched quadratic forms
``out[t, n] = alpha * h_t^T Z_n h_t + cnt_n``.

Counterpart of ``repro.kernels.block_scores`` (a Pallas kernel); the kernel
is ``csrc/block_scores.cu``.  ``launches`` counts the kernel's launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0

#: shared memory one block may take on an H100 (bytes)
MAX_SHARED_BYTES = 232_448
#: queries the kernel stages per block: 16 rows of r fp32 in dynamic
#: shared memory, beside its static 8 x 16 fp32 reduction buffer
QUERIES_PER_BLOCK = 16
_STATIC_BYTES = 8 * QUERIES_PER_BLOCK * 4
#: the widest r that fits: (232,448 - 512) // 64 = 3,624
MAX_WIDTH = (MAX_SHARED_BYTES - _STATIC_BYTES) // (QUERIES_PER_BLOCK * 4)


def block_scores(h: torch.Tensor, z: torch.Tensor, cnt: torch.Tensor, *,
                 alpha: float = 100.0) -> torch.Tensor:
    """h: (T, r); z: (N, r, r); cnt: (N,) fp32 CUDA -> (T, N) fp32."""
    global launches
    _build.check("h", h, 2)
    _build.check("z", z, 3)
    _build.check("cnt", cnt, 1)
    t, r = h.shape
    n = z.shape[0]
    if z.shape[1:] != (r, r) or cnt.shape[0] != n:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, z "
                         f"{tuple(z.shape)}, cnt {tuple(cnt.shape)}")
    if not (h.device == z.device == cnt.device):
        raise ValueError("h, z and cnt must be on one device")
    if r > MAX_WIDTH:
        raise ValueError(f"block_scores takes r <= {MAX_WIDTH}: the kernel "
                         f"stages {QUERIES_PER_BLOCK} queries of r fp32 in "
                         f"shared memory ({QUERIES_PER_BLOCK * 4 * r} bytes "
                         f"at r = {r}, plus {_STATIC_BYTES} static, over "
                         f"the {MAX_SHARED_BYTES} a block may take)")
    out = torch.empty((t, n), dtype=torch.float32, device=h.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.launch("block_scores", h.data_ptr(), z.data_ptr(), cnt.data_ptr(),
                  out.data_ptr(), t, n, r, float(alpha), h.device.index,
                  stream)
    launches += 1
    return out
