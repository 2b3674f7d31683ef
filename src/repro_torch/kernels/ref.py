"""Plain PyTorch versions of the ported kernels (``repro.kernels.ref``).

``ops.*`` runs these for CPU tensors, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def zstats_ref(w: Tensor) -> Tensor:
    """w: (n_blocks, B, r) -> (n_blocks, r, r) fp32 Gram sums."""
    w32 = w.float()
    return torch.einsum("nbi,nbj->nij", w32, w32)


def block_scores_ref(h: Tensor, z: Tensor, cnt: Tensor, alpha: float
                     ) -> Tensor:
    """h: (T, r); z: (N, r, r); cnt: (N,) -> (T, N) kernel masses."""
    h32 = h.float()
    quad = torch.einsum("nij,ti,tj->tn", z.float(), h32, h32)
    return alpha * quad + cnt[None, :]


def leaf_scores_ref(h: Tensor, rows: Tensor, alpha: float) -> Tensor:
    """h: (G, r); rows: (G, B, r) -> (G, B) quadratic-kernel scores."""
    dots = torch.einsum("gbr,gr->gb", rows.float(), h.float())
    return alpha * torch.square(dots) + 1.0


def leaf_dots_ref(h: Tensor, rows: Tensor) -> Tensor:
    """h: (G, r); rows: (G, B, r) -> (G, B) raw dot products (logits)."""
    return torch.einsum("gbr,gr->gb", rows.float(), h.float())


def midx_pair_masses_ref(h: Tensor, ct: Tensor, cnt: Tensor, alpha: float
                         ) -> Tensor:
    """h: (T, d); ct: (P, d) pair-expanded codewords; cnt: (P,) -> (T, P)
    stage-1 masses cnt_p * (alpha * <h_t, ct_p>^2 + 1)."""
    dots = h.float() @ ct.float().T
    return cnt[None, :] * (alpha * torch.square(dots) + 1.0)


def midx_list_masses_ref(h: Tensor, c1: Tensor, c2: Tensor, codes: Tensor,
                         cnt: Tensor, alpha: float) -> Tensor:
    """h: (T, d); c1: (K1, d); c2: (K2, d); codes: (P, 2); cnt: (P,)
    -> (T, P) masses cnt_j * (alpha * <h, c1[a1_j] + c2[a2_j]>^2 + 1)."""
    ct = c1.float()[codes[:, 0].long()] + c2.float()[codes[:, 1].long()]
    return midx_pair_masses_ref(h, ct, cnt, alpha)


def midx_member_scores_ref(h: Tensor, rows: Tensor, alpha: float) -> Tensor:
    """h: (G, d); rows: (G, L, d) -> (G, L) exact within-list kernel
    scores alpha * dot^2 + 1: the function of ``leaf_scores_ref``."""
    return leaf_scores_ref(h, rows, alpha)


def rff_features_ref(w: Tensor, omega: Tensor, mask: Tensor,
                     logshift: Tensor, tau: float,
                     dtype: torch.dtype = torch.float32) -> Tensor:
    """w: (L, B, d); omega: (D, d); mask: (L, B); logshift: one element
    -> (L, D) masked per-leaf sums of the positive random features,
    computed and returned in ``dtype`` (fp32, the plain version; float64
    evaluates the same function exactly enough to hold fp32 versions to).
    Materializes the (L, B, D) features the kernel never writes."""
    wx = w.to(dtype)
    dots = torch.einsum("lbd,kd->lbk", wx, omega.to(dtype)) / math.sqrt(tau)
    nrm = torch.sum(wx * wx, dim=-1, keepdim=True) / (2.0 * tau)
    feats = torch.exp(dots - nrm - logshift.to(dtype).reshape(()))
    feats = feats / math.sqrt(omega.shape[0])
    return torch.einsum("lbk,lb->lk", feats, mask.to(dtype))


def fused_lse_ref(w: Tensor, h: Tensor, ids: Tensor, corr: Tensor,
                  biasg: Tensor, abs_mode: bool = False) -> Tensor:
    """Dense oracle of the fused-head logsumexp (``kernels/fused_head.py``).

    w: (n, d); h: (T, d); ids/corr/biasg: (T, K) -> (T,) fp32
    logsumexp_k(transform(<h_t, w_{ids[t,k]}> + biasg[t,k]) - corr[t,k]).
    Gathers the rows before it upcasts (no fp32 copy of the whole table);
    materializes the (T, K, d) gather the kernel exists to avoid."""
    rows = w[ids.long()].float()                                # (T, K, d)
    o = torch.einsum("tkd,td->tk", rows, h.float()) + biasg
    tl = torch.abs(o) if abs_mode else o
    return torch.logsumexp(tl - corr, dim=-1)


def sampled_loss_ref(h: Tensor, w_neg: Tensor, logq: Tensor,
                     pos_logit: Tensor, m_total: int) -> Tensor:
    """Corrected sampled softmax with shared negatives (paper eq. 2-3).

    h: (T, d); w_neg: (m, d); logq: (m,); pos_logit: (T,) -> (T,) fp32
    logsumexp([pos, h.w_neg^T - logq - log m_total]) - pos.  Materializes
    the (T, m) adjusted logits the kernel never writes."""
    o_neg = h.float() @ w_neg.float().T
    o_adj = o_neg - logq.float()[None, :] - math.log(m_total)
    pos = pos_logit.float()
    return torch.logsumexp(torch.cat([pos[:, None], o_adj], dim=-1),
                           dim=-1) - pos


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                        s_valid: int | None = None, q_offset: int = 0,
                        chunk: int = 128, with_lse: bool = False):
    """Online-softmax attention over KV chunks: the plain version of the
    flash kernel and the reference's pure-tensor ``chunked_attention``.

    q: (B, Sq, H, hd); k: (B, Sk, KV, hd); v: (B, Sk, KV, hv) with H a
    multiple of KV (GQA: query head h reads KV head h // (H / KV)); hv may
    differ from hd.  Query i sits at position ``q_offset + i``; keys at or
    after ``s_valid`` (default Sk), and after the query when causal, carry
    no mass.  Computes in fp32 with q scaled by 1/sqrt(hd) after the cast
    (the reference's ``q * scale`` takes a numpy-float64 scale, which
    promotes a bf16 q to fp32 first) -> (B, Sq, H, hv) in q's dtype.
    Materializes (B, Sq, H, chunk) scores per chunk.  ``with_lse`` also
    returns the (B, H, Sq) fp32 log-sum-exp of each row's scaled scores
    (+inf for a row with no key), as the kernels' ``with_lse`` does."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    hv = v.shape[-1]
    group = h // kv
    n_valid = sk if s_valid is None else min(s_valid, sk)
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(b, sq, kv, group, hd)
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad))
    kf = kf.reshape(b, n_chunks, chunk, kv, hd)
    vf = vf.reshape(b, n_chunks, chunk, kv, hv)
    q_pos = q_offset + torch.arange(sq, device=q.device)

    m = torch.full((b, sq, kv, group), -torch.inf, device=q.device)
    l = torch.zeros((b, sq, kv, group), device=q.device)
    acc = torch.zeros((b, sq, kv, group, hv), device=q.device)
    for c in range(n_chunks):
        k_pos = c * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqkgh,bckh->bqkgc", qf, kf[:, c])
        mask = (k_pos < n_valid)[None, :].expand(sq, chunk)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        mask = mask[None, :, None, None, :]
        s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.exp(torch.where(torch.isneginf(m), m_new, m - m_new))
        corr = torch.where(torch.isneginf(m_new), 1.0, corr)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckh->bqkgh", p,
                                                   vf[:, c])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(b, sq, h, hv).to(q.dtype)
    if not with_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), torch.inf)
    return out, lse.reshape(b, sq, h).permute(0, 2, 1).contiguous()


def flash_attention_bwd_ref(q: Tensor, k: Tensor, v: Tensor, dout: Tensor,
                            *, causal: bool, s_valid: int | None = None
                            ) -> tuple[Tensor, Tensor, Tensor]:
    """The plain version of the attention's backward: (dq, dk, dv) in the
    inputs' dtypes, by ``torch.autograd`` through ``flash_attention_ref``
    (the forward recomputed in fp32)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_ref(*leaves, causal=causal, s_valid=s_valid)
        return torch.autograd.grad(out, leaves, dout)
