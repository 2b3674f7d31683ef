"""Plain PyTorch versions of the ported kernels (``repro.kernels.ref``).

``ops.*`` runs these for CPU tensors, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card."""
from __future__ import annotations

import math

import torch

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
                     logshift: Tensor, tau: float) -> Tensor:
    """w: (L, B, d); omega: (D, d); mask: (L, B); logshift: one element
    -> (L, D) masked per-leaf sums of the positive random features.
    Materializes the (L, B, D) features the kernel never writes."""
    w32 = w.float()
    dots = torch.einsum("lbd,kd->lbk", w32, omega.float()) / math.sqrt(tau)
    nrm = torch.sum(w32 * w32, dim=-1, keepdim=True) / (2.0 * tau)
    feats = torch.exp(dots - nrm - logshift.reshape(()))
    feats = feats / math.sqrt(omega.shape[0])
    return torch.einsum("lbk,lb->lk", feats, mask.float())


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
