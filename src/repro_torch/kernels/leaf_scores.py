"""CUDA kernel wrapper: per-draw within-leaf scores.

``square=True``: ``alpha * (rows[g, b] . h[g])^2 + 1`` (quadratic kernel);
``square=False``: raw dots ``rows[g, b] . h[g]`` (alpha ignored).
Counterpart of ``repro.kernels.leaf_scores`` (a Pallas kernel); the kernel
is ``csrc/leaf_scores.cu``.  ``launches`` counts the kernel's launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0


def leaf_scores(h: torch.Tensor, rows: torch.Tensor, *, alpha: float = 100.0,
                square: bool = True) -> torch.Tensor:
    """h: (G, r); rows: (G, B, r) fp32 CUDA -> (G, B) fp32 scores."""
    global launches
    _build.check("h", h, 2)
    _build.check("rows", rows, 3)
    g, r = h.shape
    if rows.shape[0] != g or rows.shape[2] != r:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, rows "
                         f"{tuple(rows.shape)}")
    if h.device != rows.device:
        raise ValueError("h and rows must be on one device")
    b = rows.shape[1]
    out = torch.empty((g, b), dtype=torch.float32, device=h.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.launch("leaf_scores", h.data_ptr(), rows.data_ptr(),
                  out.data_ptr(), g, b, r, float(alpha), int(square),
                  h.device.index, stream)
    launches += 1
    return out
