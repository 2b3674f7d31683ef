"""CUDA kernel wrapper: batched quadratic forms
``out[t, n] = alpha * h_t^T Z_n h_t + cnt_n``.

Counterpart of ``repro.kernels.block_scores`` (a Pallas kernel); the kernel
is ``csrc/block_scores.cu``.  ``launches`` counts the kernel's launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0


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
    out = torch.empty((t, n), dtype=torch.float32, device=h.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.launch("block_scores", h.data_ptr(), z.data_ptr(), cnt.data_ptr(),
                  out.data_ptr(), t, n, r, float(alpha), h.device.index,
                  stream)
    launches += 1
    return out
