"""Public wrappers of the ported kernels (``repro.kernels.ops``).

Dispatch is by the tensors' device, as the reference's is by backend: a
CUDA tensor goes to the hand-written CUDA kernel (a failure raises — there
is no fallback), a CPU tensor to the plain PyTorch version in ``ref``.
The CUDA kernels mask their ragged edges themselves, so the reference's
tile padding (``ops.py:36-43`` there) has no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_head, ref
from repro_torch.kernels.block_scores import block_scores as _block_scores
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd as _flash_bwd,
)
from repro_torch.kernels.leaf_scores import leaf_scores as _leaf_scores
from repro_torch.kernels.midx_scores import midx_list_masses as _midx_lists
from repro_torch.kernels.midx_scores import midx_member_scores as _midx_member
from repro_torch.kernels.rff_features import rff_features as _rff_features
from repro_torch.kernels.sampled_loss import sampled_loss as _sampled_loss
from repro_torch.kernels.zstats import zstats as _zstats

Tensor = torch.Tensor

MASK_CORR = fused_head.MASK_CORR


def _on_cuda(*ts: Tensor) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on unsupported or mixed devices: "
                     f"{[str(t.device) for t in ts]}")


def zstats(w: Tensor) -> Tensor:
    """w: (n_blocks, B, r) -> (n_blocks, r, r) fp32 block Grams."""
    if _on_cuda(w):
        return _zstats(w.contiguous())
    return ref.zstats_ref(w)


def block_scores(h: Tensor, z: Tensor, cnt: Tensor,
                 alpha: float = 100.0) -> Tensor:
    """h: (T, r); z: (N, r, r); cnt: (N,) -> (T, N) kernel masses."""
    if _on_cuda(h, z, cnt):
        return _block_scores(h.contiguous(), z.contiguous(),
                             cnt.contiguous(), alpha=alpha)
    return ref.block_scores_ref(h, z, cnt, alpha)


def leaf_scores(h: Tensor, rows: Tensor, alpha: float = 100.0) -> Tensor:
    """h: (G, r); rows: (G, B, r) -> (G, B) quadratic-kernel scores."""
    if _on_cuda(h, rows):
        return _leaf_scores(h.contiguous(), rows.contiguous(), alpha=alpha,
                            square=True)
    return ref.leaf_scores_ref(h, rows, alpha)


def leaf_dots(h: Tensor, rows: Tensor) -> Tensor:
    """h: (G, r); rows: (G, B, r) -> (G, B) raw dots <h_g, w_{g,b}>.

    The exact-scoring step of serving-side beam retrieval: the same kernel
    as ``leaf_scores``, without the kernelization."""
    if _on_cuda(h, rows):
        return _leaf_scores(h.contiguous(), rows.contiguous(), alpha=0.0,
                            square=False)
    return ref.leaf_dots_ref(h, rows)


def midx_list_masses(h: Tensor, c1: Tensor, c2: Tensor, codes: Tensor,
                     cnt: Tensor, alpha: float = 100.0) -> Tensor:
    """h: (T, d); c1: (K1, d); c2: (K2, d); codes: (P, 2); cnt: (P,)
    -> (T, P) stage-1 midx masses ``cnt_j * (alpha <h, ct_j>^2 + 1)``.

    On the card the kernel forms each codeword pair ``ct = c1[a1] +
    c2[a2]`` while it stages it (the reference's wrapper gathers it
    first); fp32 or bf16 h and codewords are read as they are, other or
    mixed types as fp32.  Lists with cnt 0 get mass exactly 0."""
    if _on_cuda(h, c1, c2, codes, cnt):
        if not h.dtype == c1.dtype == c2.dtype or h.dtype not in (
                torch.float32, torch.bfloat16):
            h, c1, c2 = h.float(), c1.float(), c2.float()
        return _midx_lists(h.contiguous(), c1.contiguous(), c2.contiguous(),
                           codes.to(torch.int32).contiguous(),
                           cnt.float().contiguous(), alpha=alpha)
    return ref.midx_list_masses_ref(h, c1, c2, codes, cnt, alpha)


def midx_member_scores(h: Tensor, rows: Tensor, alpha: float = 100.0
                       ) -> Tensor:
    """h: (G, d); rows: (G, L, d) gathered posting lists -> (G, L) exact
    within-list quadratic-kernel scores."""
    if _on_cuda(h, rows):
        return _midx_member(h.contiguous(), rows.contiguous(), alpha=alpha)
    return ref.midx_member_scores_ref(h, rows, alpha)


def rff_features(w: Tensor, omega: Tensor, mask: Tensor, logshift: Tensor,
                 *, tau: float = 1.0) -> Tensor:
    """w: (L, B, d); omega: (D, d); mask: (L, B); logshift: one-element
    tensor -> (L, D) fp32 masked per-leaf positive-RFF feature sums; the
    (n, D) feature matrix never exists on the card."""
    if _on_cuda(w, omega, mask, logshift):
        return _rff_features(w.contiguous(), omega.contiguous(),
                             mask.contiguous(), logshift.contiguous(),
                             tau=tau)
    return ref.rff_features_ref(w, omega, mask, logshift, tau)


def sampled_loss(h: Tensor, w_neg: Tensor, logq: Tensor, pos_logit: Tensor,
                 m_total: int | None = None) -> Tensor:
    """Fused corrected sampled-softmax loss, shared negatives.  -> (T,) fp32.

    h: (T, d); w_neg: (m, d); logq: (m,); pos_logit: (T,); m_total
    (default m) sets the ``log m_total`` correction.  Any T and m: the
    kernel masks its ragged tiles, and a negative the caller pads with
    ``logq = 1e30`` carries no mass.  Forward only (no backward), as in
    the reference.  h and w_neg of different dtypes are both taken as
    fp32."""
    m_total = m_total or w_neg.shape[0]
    if _on_cuda(h, w_neg, logq, pos_logit):
        if h.dtype != w_neg.dtype:
            h, w_neg = h.float(), w_neg.float()
        return _sampled_loss(h.contiguous(), w_neg.contiguous(),
                             logq.float().contiguous(),
                             pos_logit.float().contiguous(), m_total=m_total)
    return ref.sampled_loss_ref(h, w_neg, logq, pos_logit, m_total)


class _FlashAttention(torch.autograd.Function):
    """The flash kernel with its backward kernel: the forward keeps its
    inputs and per-row log-sum-exp, the backward recomputes the
    probabilities from them (``flash_attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _flash(q, k, v, causal=causal, with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, dout.contiguous(), lse,
                                causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True
                    ) -> Tensor:
    """q: (B, Sq, H, hd); k: (B, Sk, KV, hd); v: (B, Sk, KV, hv) GQA -> (B,
    Sq, H, hv); the value width hv may differ from hd (MLA), the key length
    Sk from Sq where the call is not causal (a cross attention; a causal
    call with Sk != Sq raises ``ValueError`` on either device).  k and v
    go to the kernels at their own length, never padded to Sq.

    fp32 or bf16 in, computed in fp32 (scaled by 1/sqrt(hd) in fp32),
    written in q's dtype.  The reference's ``q_tile`` and ``kv_tile`` are
    not taken: the CUDA kernels' tiles are fixed when they are compiled
    (64 queries and 64 keys for bf16 with hd and hv multiples of 16, hd up
    to 192 and hv up to 128, on the tensor cores; 64 queries and 32 keys
    otherwise) and they mask ragged S themselves.

    Differentiable on either device: for CUDA tensors under autograd with
    any input requiring a gradient, the forward kernel also writes its
    log-sum-exp and the backward is ``flash_attention_bwd`` (a
    ``torch.autograd.Function``); without a gradient the forward kernel
    runs alone, as serving calls it.  CPU tensors take the plain version,
    which autograd differentiates as it is."""
    if causal and k.shape[1] != q.shape[1]:
        raise ValueError(f"a causal call needs as many keys as queries: "
                         f"q {q.shape[1]}, k {k.shape[1]}")
    if _on_cuda(q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return _FlashAttention.apply(q, k, v, causal)
        return _flash(q, k, v, causal=causal)
    return ref.flash_attention_ref(q, k, v, causal=causal)


# --- fused sampled-softmax head (kernels/fused_head.py) ----------------------

#: token-chunk size of the plain path: peak gather is (chunk, K, d).
FUSED_HEAD_CHUNK = 128
#: impl names kept from the reference's configs.  "auto", "fused" and
#: "pallas" take the CUDA kernels for CUDA tensors (at any table size: dL/dw
#: accumulates in device memory, so the reference's VMEM cap has no
#: counterpart) and the plain chunked path for CPU tensors; "chunked" is the
#: plain path on either device.
FUSED_HEAD_IMPLS = ("auto", "fused", "pallas", "chunked")


def _chunked_lse(w: Tensor, h: Tensor, ids: Tensor, corr: Tensor,
                 biasg: Tensor, abs_mode: bool) -> Tensor:
    """Plain forward: the dense oracle over token chunks, so the peak
    intermediate is a (chunk, K, d) gather instead of (T, K, d)."""
    c = FUSED_HEAD_CHUNK
    parts = [ref.fused_lse_ref(w, h[i:i + c], ids[i:i + c], corr[i:i + c],
                               biasg[i:i + c], abs_mode)
             for i in range(0, h.shape[0], c)]
    if not parts:
        return torch.zeros((0,), dtype=torch.float32, device=h.device)
    return torch.cat(parts)


def _chunked_lse_bwd(w: Tensor, h: Tensor, ids: Tensor, corr: Tensor,
                     biasg: Tensor, lse: Tensor, gbar: Tensor,
                     abs_mode: bool
                     ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain backward: token chunks accumulate the dense (n, d) dL/dw with
    ``index_add_``; the forward is recomputed per chunk (flash-style)."""
    n, d = w.shape
    c = FUSED_HEAD_CHUNK
    dw = torch.zeros((n, d), dtype=torch.float32, device=w.device)
    dh, dcoef, dcorr = [], [], []
    for i in range(0, h.shape[0], c):
        ids_c = ids[i:i + c].long()
        h32 = h[i:i + c].float()
        rows = w[ids_c].float()  # gather, THEN upcast: (tc, K, d)
        o = torch.einsum("tkd,td->tk", rows, h32) + biasg[i:i + c]
        tl = torch.abs(o) if abs_mode else o
        p = (torch.exp((tl - corr[i:i + c]) - lse[i:i + c, None])
             * gbar[i:i + c, None])
        dcorr.append(-p)  # corr applies after |.|: no sign chain
        if abs_mode:
            p = p * torch.sign(o)
        dcoef.append(p)
        dh.append(torch.einsum("tk,tkd->td", p, rows))
        dw.index_add_(0, ids_c.reshape(-1),
                      (p[..., None] * h32[:, None, :]).reshape(-1, d))
    return dw, torch.cat(dh), torch.cat(dcoef), torch.cat(dcorr)


class _FusedHeadLSE(torch.autograd.Function):
    """The fused head with its VJP: the CUDA kernels (``kernel=True``) or
    the plain chunked path, forward and backward alike."""

    @staticmethod
    def forward(ctx, w, h, ids, corr, biasg, abs_mode, kernel):
        if kernel:
            lse = fused_head.fused_lse(w, h, ids, corr, biasg,
                                       abs_mode=abs_mode)
        else:
            lse = _chunked_lse(w, h, ids, corr, biasg, abs_mode)
        ctx.save_for_backward(w, h, ids, corr, biasg, lse)
        ctx.abs_mode, ctx.kernel = abs_mode, kernel
        return lse

    @staticmethod
    def backward(ctx, gbar):
        w, h, ids, corr, biasg, lse = ctx.saved_tensors
        gbar = gbar.float().contiguous()
        if ctx.kernel:
            dw, dh, dcoef, dcorr = fused_head.fused_lse_bwd(
                w, h, ids, corr, biasg, lse, gbar, abs_mode=ctx.abs_mode)
        else:
            dw, dh, dcoef, dcorr = _chunked_lse_bwd(
                w, h, ids, corr, biasg, lse, gbar, ctx.abs_mode)
        return (dw.to(w.dtype), dh.to(h.dtype), None, dcorr, dcoef, None,
                None)


def fused_head_lse(w: Tensor, h: Tensor, ids: Tensor, corr: Tensor,
                   biasg: Tensor | None = None, *, abs_mode: bool = False,
                   impl: str = "auto") -> Tensor:
    """Fused sampled-softmax head: per-token corrected logsumexp.  -> (T,).

    w: (n, d) head table; h: (T, d) hidden states; ids: (T, K) rows to
    gather; corr: (T, K) per-slot corrections SUBTRACTED after the abs-mode
    transform (0 for a positive slot, ``ln(m q)`` for a negative per eq. 2,
    ``MASK_CORR`` for accidental hits / padding — those slots contribute
    exactly zero mass and zero gradient); biasg: optional (T, K) pre-gathered
    class bias ADDED to the raw logit before the transform.

    Differentiable wrt w, h, corr and biasg (``torch.autograd.Function``):
    the backward scatter-adds dL/dw and accumulates dL/dh; the kernels never
    materialize the (T, K, d) gather, the plain path one (128, K, d) chunk
    at a time.  ``impl``: see ``FUSED_HEAD_IMPLS``.
    On the card the kernels read fp32 or bf16 ``w`` and ``h`` as they are
    and compute in fp32, as the Pallas kernels cast each loaded row; a
    head and hidden states of different dtypes (or another float type) are
    both taken as fp32."""
    if impl not in FUSED_HEAD_IMPLS:
        raise ValueError(f"fused_head_lse impl={impl!r} not in "
                         f"{FUSED_HEAD_IMPLS}")
    kernel = impl != "chunked" and _on_cuda(w, h, ids, corr)
    t, k = ids.shape
    if biasg is None:
        biasg = torch.zeros((t, k), dtype=torch.float32, device=h.device)
    # int32 at the kernel's boundary, int64 for the plain path's indexing:
    # converted once per call, never per slot.
    ids = ids.to(torch.int32 if kernel else torch.int64).contiguous()
    if kernel:
        if w.dtype != h.dtype or w.dtype not in (torch.float32,
                                                 torch.bfloat16):
            w, h = w.float(), h.float()
        w, h = w.contiguous(), h.contiguous()
    return _FusedHeadLSE.apply(w, h, ids, corr.float().contiguous(),
                               biasg.float().contiguous(), bool(abs_mode),
                               kernel)
