"""CUDA kernel wrapper: causal (or full) online-softmax GQA attention,
forward only.

Counterpart of ``repro.kernels.flash_attention`` (a Pallas kernel); the
kernel is ``csrc/flash_attention.cu``.  It takes the reference's
``ops.flash_attention`` layout directly, q (B, S, H, hd) and k, v (B, S,
KV, hd), and reads KV head ``h // (H // KV)`` in place, so neither the
reference's repeated-KV copy nor its head-major transposes exist here.
``launches`` counts the kernel's launches."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

launches = 0

#: widest head the kernel's shared-memory tiles take
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, s_valid: int | None = None
                    ) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) CUDA, all fp32 or all bf16,
    H a multiple of KV -> (B, S, H, hd) in q's dtype.  Keys at or after
    ``s_valid`` (default S) carry no mass."""
    global launches
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be one of {_DTYPES}, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check(name, t, 4, q.dtype)
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if k.shape != (b, s, kv, hd) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside 1..{MAX_HEAD_DIM}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    s_valid = s if s_valid is None else int(s_valid)
    if s_valid < 1:
        raise ValueError(f"s_valid must be >= 1, got {s_valid}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, s, h, kv, hd,
                  min(s_valid, s), int(causal), 1.0 / math.sqrt(hd),
                  int(q.dtype == torch.bfloat16), q.device.index, stream)
    launches += 1
    return out
