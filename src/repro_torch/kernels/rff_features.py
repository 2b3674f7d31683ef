"""CUDA kernel wrapper: masked per-leaf sums of positive random features

    out[l, k] = D^{-1/2} sum_b mask[l, b] exp(<omega_k, w[l, b]>/sqrt(tau)
                                              - |w[l, b]|^2/(2 tau) - logshift)

Counterpart of ``repro.kernels.rff_features`` (a Pallas kernel); the kernel
is ``csrc/rff_features.cu``.  ``logshift`` stays on the card: the kernel
reads it from device memory, so a call never waits for the device.
``launches`` counts the kernel's launches."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

launches = 0


def rff_features(w: torch.Tensor, omega: torch.Tensor, mask: torch.Tensor,
                 logshift: torch.Tensor, *, tau: float = 1.0) -> torch.Tensor:
    """w: (L, B, d); omega: (D, d); mask: (L, B); logshift: one element,
    fp32 CUDA -> (L, D) fp32 feature sums."""
    global launches
    _build.check("w", w, 3)
    _build.check("omega", omega, 2)
    _build.check("mask", mask, 2)
    _build.check("logshift", logshift, logshift.dim())
    n_leaves, b, d = w.shape
    n_feat = omega.shape[0]
    if (omega.shape[1] != d or mask.shape != (n_leaves, b)
            or logshift.numel() != 1):
        raise ValueError(f"shape mismatch: w {tuple(w.shape)}, omega "
                         f"{tuple(omega.shape)}, mask {tuple(mask.shape)}, "
                         f"logshift {tuple(logshift.shape)}")
    if not (w.device == omega.device == mask.device == logshift.device):
        raise ValueError("w, omega, mask and logshift must be on one device")
    if tau <= 0:
        raise ValueError(f"tau must be positive, got {tau}")
    out = torch.empty((n_leaves, n_feat), dtype=torch.float32,
                      device=w.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(w.device).cuda_stream
    _build.launch("rff_features", w.data_ptr(), omega.data_ptr(),
                  mask.data_ptr(), logshift.data_ptr(), out.data_ptr(),
                  n_leaves, b, d, n_feat, 1.0 / math.sqrt(tau),
                  0.5 / tau, 1.0 / math.sqrt(n_feat), w.device.index, stream)
    launches += 1
    return out
