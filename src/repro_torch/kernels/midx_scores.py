"""CUDA kernel wrappers: the midx sampler's two scoring stages.

``midx_pair_masses``: stage-1 list masses ``cnt[p] * (alpha * <h[t],
ct[p]>^2 + 1)`` against the pair-expanded codewords ``ct``;
``midx_member_scores``: stage-2 scores ``alpha * <rows[g, l], h[g]>^2 + 1``
over each draw's gathered posting list.  Counterparts of
``repro.kernels.midx_scores`` (Pallas kernels); the kernels are
``csrc/midx_scores.cu``.  ``pair_launches`` and ``member_launches`` count
their launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

pair_launches = 0
member_launches = 0


def midx_pair_masses(h: torch.Tensor, ct: torch.Tensor, cnt: torch.Tensor,
                     *, alpha: float = 100.0) -> torch.Tensor:
    """h: (T, d); ct: (P, d); cnt: (P,) fp32 CUDA -> (T, P) fp32 masses."""
    global pair_launches
    _build.check("h", h, 2)
    _build.check("ct", ct, 2)
    _build.check("cnt", cnt, 1)
    t, d = h.shape
    p = ct.shape[0]
    if ct.shape[1] != d or cnt.shape[0] != p:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, ct "
                         f"{tuple(ct.shape)}, cnt {tuple(cnt.shape)}")
    if not (h.device == ct.device == cnt.device):
        raise ValueError("h, ct and cnt must be on one device")
    out = torch.empty((t, p), dtype=torch.float32, device=h.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.launch("midx_pair_masses", h.data_ptr(), ct.data_ptr(),
                  cnt.data_ptr(), out.data_ptr(), t, p, d, float(alpha),
                  h.device.index, stream)
    pair_launches += 1
    return out


def midx_member_scores(h: torch.Tensor, rows: torch.Tensor, *,
                       alpha: float = 100.0) -> torch.Tensor:
    """h: (G, d); rows: (G, L, d) fp32 CUDA -> (G, L) fp32 scores."""
    global member_launches
    _build.check("h", h, 2)
    _build.check("rows", rows, 3)
    g, d = h.shape
    if rows.shape[0] != g or rows.shape[2] != d:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, rows "
                         f"{tuple(rows.shape)}")
    if h.device != rows.device:
        raise ValueError("h and rows must be on one device")
    n_list = rows.shape[1]
    out = torch.empty((g, n_list), dtype=torch.float32, device=h.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.launch("midx_member_scores", h.data_ptr(), rows.data_ptr(),
                  out.data_ptr(), g, n_list, d, float(alpha), h.device.index,
                  stream)
    member_launches += 1
    return out
