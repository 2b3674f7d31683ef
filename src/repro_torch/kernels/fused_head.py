"""CUDA kernel wrappers: the fused sampled-softmax head.

``fused_lse``: per-token ``logsumexp_k(f(<h_t, w[ids[t,k]]> + biasg[t,k]) -
corr[t,k])`` with f the identity or ``|.|`` (``abs_mode``); ``fused_lse_bwd``:
its VJP.  Counterparts of ``repro.kernels.fused_head`` (Pallas kernels); the
kernels are ``csrc/fused_head.cu``.  ``fwd_launches`` and ``bwd_launches``
count their launches.

``ids`` are int32 on the card: ``ops.fused_head_lse`` converts the port's
int64 ids once, at this boundary.  Ids are not range-checked here (that
would cost a device sync per call): rows outside ``w`` are a caller error.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

#: running-max start of the online logsumexp (as the Pallas scratch init)
NEG_INF = -1e30
#: corr value that forces a slot's mass to exactly zero (masked / padded)
MASK_CORR = 1e30

fwd_launches = 0
bwd_launches = 0


def _check(w: Tensor, h: Tensor, ids: Tensor, corr: Tensor,
           biasg: Tensor) -> tuple[int, int, int]:
    _build.check("w", w, 2)
    _build.check("h", h, 2)
    _build.check("ids", ids, 2, torch.int32)
    _build.check("corr", corr, 2)
    _build.check("biasg", biasg, 2)
    t, d = h.shape
    k = ids.shape[1]
    if (w.shape[1] != d or ids.shape[0] != t or corr.shape != ids.shape
            or biasg.shape != ids.shape):
        raise ValueError(f"shape mismatch: w {tuple(w.shape)}, h "
                         f"{tuple(h.shape)}, ids {tuple(ids.shape)}, corr "
                         f"{tuple(corr.shape)}, biasg {tuple(biasg.shape)}")
    if k == 0:
        raise ValueError("ids must hold at least one slot per token")
    if len({x.device for x in (w, h, ids, corr, biasg)}) != 1:
        raise ValueError("w, h, ids, corr and biasg must be on one device")
    return t, k, d


def fused_lse(w: Tensor, h: Tensor, ids: Tensor, corr: Tensor,
              biasg: Tensor, *, abs_mode: bool = False) -> Tensor:
    """w: (n, d); h: (T, d); ids (int32) / corr / biasg: (T, K), CUDA
    -> (T,) fp32 per-token corrected logsumexp."""
    global fwd_launches
    t, k, d = _check(w, h, ids, corr, biasg)
    lse = torch.empty((t,), dtype=torch.float32, device=h.device)
    if t == 0:
        return lse
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.launch("fused_lse", w.data_ptr(), h.data_ptr(), ids.data_ptr(),
                  corr.data_ptr(), biasg.data_ptr(), lse.data_ptr(), t, k, d,
                  int(abs_mode), h.device.index, stream)
    fwd_launches += 1
    return lse


def fused_lse_bwd(w: Tensor, h: Tensor, ids: Tensor, corr: Tensor,
                  biasg: Tensor, lse: Tensor, gbar: Tensor, *,
                  abs_mode: bool = False
                  ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """VJP of ``fused_lse`` wrt (w, h, biasg, corr).

    lse: (T,) forward output; gbar: (T,) upstream cotangent.  Returns
    (dw (n, d), dh (T, d), dcoef (T, K), dcorr (T, K)) fp32: dcoef is the
    sign-chained per-slot softmax weight (the biasg cotangent), dcorr minus
    the unsigned weight (corr applies after the abs transform).  dw is dense
    and zero-filled here, then accumulated by the kernel's atomics."""
    global bwd_launches
    t, k, d = _check(w, h, ids, corr, biasg)
    _build.check("lse", lse, 1)
    _build.check("gbar", gbar, 1)
    if lse.shape[0] != t or gbar.shape[0] != t:
        raise ValueError(f"lse {tuple(lse.shape)} and gbar "
                         f"{tuple(gbar.shape)} must be ({t},)")
    dev = h.device
    dw = torch.zeros(w.shape, dtype=torch.float32, device=dev)
    dh = torch.empty((t, d), dtype=torch.float32, device=dev)
    dcoef = torch.empty((t, k), dtype=torch.float32, device=dev)
    dcorr = torch.empty((t, k), dtype=torch.float32, device=dev)
    if t == 0:
        return dw, dh, dcoef, dcorr
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.launch("fused_lse_bwd", w.data_ptr(), h.data_ptr(),
                  ids.data_ptr(), corr.data_ptr(), biasg.data_ptr(),
                  lse.data_ptr(), gbar.data_ptr(), dw.data_ptr(),
                  dh.data_ptr(), dcoef.data_ptr(), dcorr.data_ptr(), t, k, d,
                  int(abs_mode), dev.index, stream)
    bwd_launches += 1
    return dw, dh, dcoef, dcorr
