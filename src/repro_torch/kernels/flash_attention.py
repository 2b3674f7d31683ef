"""CUDA kernel wrappers: causal (or full) online-softmax GQA attention,
forward (``flash_attention``, optionally with its log-sum-exp) and
backward (``flash_attention_bwd``).

Counterpart of ``repro.kernels.flash_attention`` (a Pallas kernel, forward
only; the reference differentiates its pure-jnp ``chunked_attention``);
the kernels are in ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``.  They take the reference's
``ops.flash_attention`` layout directly, q (B, S, H, hd) and k, v (B, S,
KV, hd), and read (and the backward writes) KV head ``h // (H // KV)`` in
place, so neither the reference's repeated-KV copy nor its head-major
transposes exist here.

Two routes each way, picked by dtype and width (``uses_tensor_cores``):
bf16 with hd a multiple of 16 up to 128 goes to the tensor-core kernels
(``mma.sync``, counted in ``launches`` and ``bwd_launches``), everything
else (fp32, other widths up to 256) to the CUDA-core kernels
(``flash_attention_simt``, counted in ``simt_launches`` and
``bwd_simt_launches``).  The backward's two kernels (dQ, whose first pass
sums D = rowsum(P o dP); then dK/dV) sit behind one entry point and count
as one launch."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

#: launches of the tensor-core kernel
launches = 0
#: launches of the CUDA-core kernel
simt_launches = 0
#: launches of the tensor-core backward
bwd_launches = 0
#: launches of the CUDA-core backward
bwd_simt_launches = 0

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
            causal: bool, s_valid: int, *extra,
            lse: torch.Tensor | None = None) -> torch.Tensor:
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if lse is not None:
        name, ptrs = name + "_lse", ptrs + (lse.data_ptr(),)
    _build.launch(name, *ptrs, b, s, h, k.shape[2], hd, s_valid,
                  int(causal), 1.0 / math.sqrt(hd), *extra, q.device.index,
                  stream)
    return out


def _lse_out(q: torch.Tensor) -> torch.Tensor:
    b, s, h, _ = q.shape
    return torch.empty((b, h, s), dtype=torch.float32, device=q.device)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, s_valid: int | None = None,
                    with_lse: bool = False):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) CUDA, all fp32 or all bf16,
    H a multiple of KV -> (B, S, H, hd) in q's dtype.  Keys at or after
    ``s_valid`` (default S) carry no mass.  ``with_lse`` also returns the
    (B, H, S) fp32 natural-log sum of exp(q.k / sqrt(hd)) over each row's
    keys, the backward's residual: ``(out, lse)``."""
    global launches
    s_valid = _checked(q, k, v, s_valid)
    if not uses_tensor_cores(q, k, v):
        return flash_attention_simt(q, k, v, causal=causal, s_valid=s_valid,
                                    with_lse=with_lse)
    lse = _lse_out(q) if with_lse else None
    if q.numel() == 0:
        out = torch.empty_like(q)
    else:
        out = _launch("flash_attention", q, k, v, causal, s_valid, lse=lse)
        launches += 1
    return (out, lse) if with_lse else out


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, s_valid: int | None = None,
                         with_lse: bool = False):
    """The CUDA-core kernel alone, for any input ``flash_attention`` takes
    (fp32 or bf16, hd up to 256)."""
    global simt_launches
    s_valid = _checked(q, k, v, s_valid)
    lse = _lse_out(q) if with_lse else None
    if q.numel() == 0:
        out = torch.empty_like(q)
    else:
        out = _launch("flash_attention_simt", q, k, v, causal, s_valid,
                      int(q.dtype == torch.bfloat16), lse=lse)
        simt_launches += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor, *,
                        causal: bool = True, s_valid: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` for the
    output gradient ``dout``, given the forward's ``lse`` (from
    ``with_lse=True``): q, dout (B, S, H, hd), k, v (B, S, KV, hd) in one
    dtype, lse (B, H, S) fp32.  The probabilities are recomputed from lse,
    and D = rowsum(dout o out) as rowsum(P o dP) from them in fp32, so the
    forward's output is not read (its rounding to q's dtype would enter
    every dS).  Every gradient element is summed by one thread in a fixed
    order, so two calls give the same bits.  bf16 at the tensor-core widths
    takes the tensor-core kernels, anything else the CUDA-core ones."""
    global bwd_launches, bwd_simt_launches
    s_valid = _checked(q, k, v, s_valid)
    _build.check("dout", dout, 4, q.dtype)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    b, s, h, hd = q.shape
    _build.check("lse", lse, 3)
    if lse.shape != (b, h, s):
        raise ValueError(f"lse {tuple(lse.shape)} != {(b, h, s)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    tc = uses_tensor_cores(q, k, v) and all(
        t.data_ptr() % 16 == 0 for t in (dout, dq, dk, dv))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, s, h, k.shape[2], hd, s_valid, int(causal),
            1.0 / math.sqrt(hd)]
    if tc:
        _build.launch("flash_attention_bwd", *args, q.device.index, stream)
        bwd_launches += 1
    else:
        _build.launch("flash_attention_bwd_simt", *args,
                      int(q.dtype == torch.bfloat16), q.device.index, stream)
        bwd_simt_launches += 1
    return dq, dk, dv
