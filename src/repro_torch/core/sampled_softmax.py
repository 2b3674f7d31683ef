"""Sampled softmax with expected-occurrence correction (paper §2.2) and the
absolute-softmax prediction distribution (paper §3.3) —
``repro.core.sampled_softmax``.

Conventions:
  * one positive class per example;
  * negatives are sampled WITH replacement from a known distribution q and
    the logit of a sampled negative is corrected as  o' = o - ln(m * q)
    (eq. 2);
  * the loss is the cross entropy over the m+1 adjusted logits (eq. 3);
  * ``abs_mode`` applies |.| to the raw logits before anything else (eq. 11);
  * ACCIDENTAL HITS: a draw that collides with the label is masked AFTER the
    correction (zero mass, zero gradient), which keeps the estimator
    consistent for any q.

The per-example loss path dispatches to the fused head
(``kernels.ops.fused_head_lse``: the CUDA kernels on the card): gather +
eq. 2 correction + hit mask + abs transform + (m+1)-way logsumexp, never
materializing the (T, m, d) negative-embedding tensor the einsum path
gathers.  The einsum path stays as the oracle (``impl="einsum"``); shared
``(m,)`` negatives always use it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops

Tensor = torch.Tensor


def transform_logits(o: Tensor, abs_mode: bool) -> Tensor:
    """Prediction-distribution transform: identity or |o| (paper eq. 11)."""
    return torch.abs(o) if abs_mode else o


def _log_m(m: int, like: Tensor) -> Tensor:
    """ln(m) in ``like``'s type, as the reference computes it."""
    return torch.log(torch.tensor(float(m), dtype=like.dtype,
                                  device=like.device))


def adjust_neg_logits(o_neg: Tensor, logq: Tensor, m: int) -> Tensor:
    """eq. 2:  o'_i = o_i - ln(m q_i)  for sampled negatives."""
    return o_neg - (logq + _log_m(m, o_neg))


def sampled_softmax_loss(pos_logit: Tensor, neg_logits: Tensor, logq: Tensor,
                         *, abs_mode: bool = False,
                         hit_mask: Tensor | None = None) -> Tensor:
    """Cross entropy over [positive, m corrected negatives]  (eq. 3).

    pos_logit: (...,) raw logit of the positive class; neg_logits: (..., m)
    raw logits of the negatives (a shared (m,) set broadcasts); logq:
    (..., m) exact log sampling probabilities; hit_mask: optional (..., m)
    bool, True where a negative collided with the label.
    Returns per-example loss (...,)."""
    m = neg_logits.shape[-1]
    pos = transform_logits(pos_logit, abs_mode)
    neg = adjust_neg_logits(transform_logits(neg_logits, abs_mode), logq, m)
    if hit_mask is not None:
        neg = torch.where(hit_mask, -math.inf, neg)
    neg = torch.broadcast_to(neg, (*pos.shape, m))
    all_logits = torch.cat([pos[..., None], neg], dim=-1)
    return torch.logsumexp(all_logits, dim=-1) - pos


def gather_pos_neg_logits(w: Tensor, h: Tensor, labels: Tensor,
                          neg_ids: Tensor, logq: Tensor,
                          bias: Tensor | None = None
                          ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Raw (pos_logit (T,), neg_logits (T, m), logq (T, m), hit (T, m)):
    the one local gather + einsum + hit detection + bias block every
    estimator's einsum path shares (shared (m,) negatives broadcast)."""
    h = h.float()
    pos_logit = torch.einsum("td,td->t", h, w[labels].float())
    w_neg = w[neg_ids].float()
    if neg_ids.dim() == 1:  # shared negatives
        neg_logits = torch.einsum("td,md->tm", h, w_neg)
        logq = torch.broadcast_to(logq[None, :], neg_logits.shape)
        hit = neg_ids[None, :] == labels[:, None]
    else:
        neg_logits = torch.einsum("td,tmd->tm", h, w_neg)
        hit = neg_ids == labels[:, None]
    if bias is not None:
        pos_logit = pos_logit + bias[labels]
        neg_logits = neg_logits + bias[neg_ids]
    return pos_logit, neg_logits, logq, hit


def sampled_softmax_from_embeddings(
        w: Tensor, h: Tensor, labels: Tensor, neg_ids: Tensor, logq: Tensor,
        *, abs_mode: bool = False, bias: Tensor | None = None,
        mask_accidental_hits: bool = True, impl: str = "auto") -> Tensor:
    """Per-example loss (T,) from the class-embedding table.

    w: (n, d); h: (T, d); labels: (T,); neg_ids/logq: (T, m) per-example or
    (m,) shared negatives.  ``impl``: "einsum" is the dense oracle; every
    other name routes per-example negatives through the fused head
    (``ops.FUSED_HEAD_IMPLS``).  Shared negatives take the einsum path."""
    if neg_ids.dim() == 2 and impl != "einsum":
        return _fused_from_embeddings(
            w, h, labels, neg_ids, logq, abs_mode=abs_mode, bias=bias,
            mask_accidental_hits=mask_accidental_hits, impl=impl)
    pos_logit, neg_logits, logq, hit = gather_pos_neg_logits(
        w, h, labels, neg_ids, logq, bias)
    return sampled_softmax_loss(
        pos_logit, neg_logits, logq, abs_mode=abs_mode,
        hit_mask=hit if mask_accidental_hits else None)


def fused_plan(labels: Tensor, neg_ids: Tensor, logq: Tensor, *,
               mask_accidental_hits: bool = True) -> tuple[Tensor, Tensor]:
    """The fused head's (T, 1+m) gather plan: ids (column 0 the label,
    columns 1..m the negatives) and corr (0 for the label, ln(m q) for a
    negative, MASK_CORR on accidental hits)."""
    t, m = neg_ids.shape
    corr_neg = logq.float() + _log_m(m, logq.float())
    if mask_accidental_hits:
        corr_neg = torch.where(neg_ids == labels[:, None], ops.MASK_CORR,
                               corr_neg)
    ids = torch.cat([labels[:, None], neg_ids], dim=1)
    corr = torch.cat([torch.zeros((t, 1), dtype=torch.float32,
                                  device=corr_neg.device), corr_neg], dim=1)
    return ids, corr


def _fused_from_embeddings(w, h, labels, neg_ids, logq, *, abs_mode, bias,
                           mask_accidental_hits, impl):
    """Per-example negatives through the fused head: the ``fused_plan``
    gather, and the separately computed positive logit subtracted from the
    head's logsumexp."""
    ids, corr = fused_plan(labels, neg_ids, logq,
                           mask_accidental_hits=mask_accidental_hits)
    biasg = bias[ids] if bias is not None else None
    lse = ops.fused_head_lse(w, h, ids, corr, biasg, abs_mode=abs_mode,
                             impl=impl)
    pos_logit = torch.einsum("td,td->t", h.float(), w[labels].float())
    if bias is not None:
        pos_logit = pos_logit + bias[labels]
    return lse - transform_logits(pos_logit, abs_mode)


def full_softmax_loss(w: Tensor, h: Tensor, labels: Tensor, *,
                      abs_mode: bool = False,
                      bias: Tensor | None = None) -> Tensor:
    """Reference full softmax cross entropy (eq. 1).  O(n d) per example."""
    logits = torch.einsum("td,nd->tn", h.float(), w.float())
    if bias is not None:
        logits = logits + bias[None, :]
    logits = transform_logits(logits, abs_mode)
    lse = torch.logsumexp(logits, dim=-1)
    pos = torch.gather(logits, 1, labels[:, None].long())[:, 0]
    return lse - pos


def full_softmax_grad_wrt_logits(o: Tensor, labels: Tensor, *,
                                 abs_mode: bool = False) -> Tensor:
    """dL/do = p - y (eq. 4), with the |.| chain rule in abs mode (test
    oracle for Theorem 2.1)."""
    t = transform_logits(o, abs_mode)
    p = torch.softmax(t, dim=-1)
    y = torch.nn.functional.one_hot(labels.long(), o.shape[-1]).to(p.dtype)
    g = p - y
    if abs_mode:
        g = g * torch.sign(o)
    return g


def sampled_softmax_grad_wrt_logits(o: Tensor, labels, neg_ids: Tensor,
                                    logq: Tensor, *, n: int,
                                    abs_mode: bool = False,
                                    mask_hits: bool = False) -> Tensor:
    """eq. 5: scatter of (p' - y') onto the original logit vector.

    o: (n,) full logits of ONE example; labels: its label (0-dim);
    neg_ids/logq: (m,).  ``mask_hits`` drops negatives that collided with
    the label.  Returns the estimator of dL/do: (n,)."""
    labels = torch.as_tensor(labels, device=o.device).long()
    neg_ids = neg_ids.long()
    m = neg_ids.shape[-1]
    pos_logit = o[labels]
    neg_logits = o[neg_ids]
    pos_t = transform_logits(pos_logit, abs_mode)
    neg_t = adjust_neg_logits(transform_logits(neg_logits, abs_mode), logq, m)
    if mask_hits:
        neg_t = torch.where(neg_ids == labels, -math.inf, neg_t)
    p_prime = torch.softmax(torch.cat([pos_t[None], neg_t]), dim=0)
    grad = torch.zeros(n, dtype=o.dtype, device=o.device)
    if abs_mode:
        signs = torch.sign(torch.cat([pos_logit[None], neg_logits]))
        p_prime = p_prime * signs
        grad[labels] -= torch.sign(pos_logit)
    else:
        grad[labels] -= 1.0
    ids = torch.cat([labels[None], neg_ids])
    return grad.index_put_((ids,), p_prime, accumulate=True)
