"""CUDA kernel wrapper: causal (or full) online-softmax GQA attention,
forward only.

Counterpart of ``repro.kernels.flash_attention`` (a Pallas kernel); the
kernels are in ``csrc/flash_attention.cu``.  They take the reference's
``ops.flash_attention`` layout directly, q (B, S, H, hd) and k, v (B, S,
KV, hd), and read KV head ``h // (H // KV)`` in place, so neither the
reference's repeated-KV copy nor its head-major transposes exist here.

Two entry points, picked by dtype and width (``uses_tensor_cores``):
bf16 with hd a multiple of 16 up to 128 goes to the tensor-core kernel
(``mma.sync``, counted in ``launches``), everything else (fp32, other
widths up to 256) to the CUDA-core kernel (``flash_attention_simt``,
counted in ``simt_launches``)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

#: launches of the tensor-core kernel
launches = 0
#: launches of the CUDA-core kernel
simt_launches = 0

#: widest head the CUDA-core kernel's shared-memory tiles take
MAX_HEAD_DIM = 256
#: widest head the tensor-core kernel takes (hd a multiple of MMA_K)
MMA_MAX_HEAD_DIM = 128
MMA_K = 16
_DTYPES = (torch.float32, torch.bfloat16)


def _checked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             s_valid: int | None) -> int:
    """Raise unless the kernels take q, k, v; returns s_valid, clipped."""
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
    return min(s_valid, s)


def uses_tensor_cores(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> bool:
    """Whether ``flash_attention`` takes the tensor-core kernel: bf16, hd a
    multiple of 16 up to 128, and 16-byte aligned bases (its copies move
    16 bytes at a time)."""
    hd = q.shape[-1]
    return (q.dtype == torch.bfloat16 and hd % MMA_K == 0
            and hd <= MMA_MAX_HEAD_DIM
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, s_valid: int, *extra) -> torch.Tensor:
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), b, s, h, k.shape[2], hd, s_valid,
                  int(causal), 1.0 / math.sqrt(hd), *extra, q.device.index,
                  stream)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, s_valid: int | None = None
                    ) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) CUDA, all fp32 or all bf16,
    H a multiple of KV -> (B, S, H, hd) in q's dtype.  Keys at or after
    ``s_valid`` (default S) carry no mass."""
    global launches
    s_valid = _checked(q, k, v, s_valid)
    if not uses_tensor_cores(q, k, v):
        return flash_attention_simt(q, k, v, causal=causal, s_valid=s_valid)
    if q.numel() == 0:
        return torch.empty_like(q)
    out = _launch("flash_attention", q, k, v, causal, s_valid)
    launches += 1
    return out


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, s_valid: int | None = None
                         ) -> torch.Tensor:
    """The CUDA-core kernel alone, for any input ``flash_attention`` takes
    (fp32 or bf16, hd up to 256)."""
    global simt_launches
    s_valid = _checked(q, k, v, s_valid)
    if q.numel() == 0:
        return torch.empty_like(q)
    out = _launch("flash_attention_simt", q, k, v, causal, s_valid,
                  int(q.dtype == torch.bfloat16))
    simt_launches += 1
    return out
