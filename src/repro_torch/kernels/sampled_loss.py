"""CUDA kernel wrapper: the fused corrected sampled-softmax loss with
shared negatives (paper eq. 2-3), forward only.

Counterpart of ``repro.kernels.sampled_loss`` (a Pallas kernel); the kernel
is ``csrc/sampled_loss.cu``.  ``launches`` counts the kernel's launches."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

launches = 0

_DTYPES = (torch.float32, torch.bfloat16)


def sampled_loss(h: torch.Tensor, w_neg: torch.Tensor, logq: torch.Tensor,
                 pos_logit: torch.Tensor, *, m_total: int) -> torch.Tensor:
    """h: (T, d) and w_neg: (m, d) CUDA, both fp32 or both bf16; logq:
    (m,) and pos_logit: (T,) fp32 -> (T,) fp32 per-example loss
    ``logsumexp([pos, h.w_neg^T - logq - log m_total]) - pos``."""
    global launches
    if h.dtype not in _DTYPES:
        raise TypeError(f"h must be one of {_DTYPES}, got {h.dtype}")
    _build.check("h", h, 2, h.dtype)
    _build.check("w_neg", w_neg, 2, h.dtype)
    _build.check("logq", logq, 1)
    _build.check("pos_logit", pos_logit, 1)
    t, d = h.shape
    m = w_neg.shape[0]
    if w_neg.shape[1] != d or logq.shape[0] != m or pos_logit.shape[0] != t:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, w_neg "
                         f"{tuple(w_neg.shape)}, logq {tuple(logq.shape)}, "
                         f"pos_logit {tuple(pos_logit.shape)}")
    if not (h.device == w_neg.device == logq.device == pos_logit.device):
        raise ValueError("h, w_neg, logq and pos_logit must be on one device")
    if m_total < 1:
        raise ValueError(f"m_total must be >= 1, got {m_total}")
    out = torch.empty((t,), dtype=torch.float32, device=h.device)
    if t == 0:
        return out
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.launch("sampled_loss", h.data_ptr(), w_neg.data_ptr(),
                  logq.data_ptr(), pos_logit.data_ptr(), out.data_ptr(), t,
                  m, d, math.log(m_total), int(h.dtype == torch.bfloat16),
                  h.device.index, stream)
    launches += 1
    return out
