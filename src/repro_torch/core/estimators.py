"""Pluggable loss estimators behind the sampled-softmax head
(``repro.core.estimators``).

Every sampled estimator consumes the same contract

    loss(pos_logit, neg_logits, logq, hit_mask, *, abs_mode) -> (...,)

with RAW logits, the sampler's exact ``logq`` and the accidental-hit mask:

  sampled-softmax   eq. 2/3 (the paper's estimator; the default).
  nce               softplus(-pos) + sum softplus(neg - ln(m q)); collided
                    slots are KEPT (noise-labelled, as in TF's nce_loss).
  sampled-logistic  nce with collided slots REMOVED.
  full              the dense oracle: exact softmax cross entropy over all n
                    classes; ``needs_sampling`` is False, so nothing samples.

As in the reference, the ln(m q) correction applies to the NEGATIVES ONLY:
under nce / sampled-logistic the positive score absorbs a +ln(m q(label|h))
offset relative to textbook NCE (q(label) is outside the contract).

``loss_from_embeddings`` routes the default estimator through
``sampled_softmax_from_embeddings`` so the fused head serves the
per-example path, gathers plain logits for the logistic family, and
short-circuits ``full`` to the dense reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.sampled_softmax import (
    _log_m,
    full_softmax_loss,
    gather_pos_neg_logits,
    sampled_softmax_from_embeddings,
    sampled_softmax_loss,
    transform_logits,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Estimator:
    """Base estimator; subclasses implement ``loss`` on the shared contract.

    ``needs_sampling`` False marks dense estimators (routed through
    ``dense_loss``); ``masks_hits`` documents the accidental-hit policy."""

    name: str = "base"
    needs_sampling: bool = True
    masks_hits: bool = True

    def loss(self, pos_logit: Tensor, neg_logits: Tensor, logq: Tensor,
             hit_mask: Tensor | None, *, abs_mode: bool = False) -> Tensor:
        raise NotImplementedError

    def dense_loss(self, w: Tensor, h: Tensor, labels: Tensor, *,
                   abs_mode: bool = False,
                   bias: Tensor | None = None) -> Tensor:
        raise TypeError(f"estimator '{self.name}' needs sampled negatives")


@dataclasses.dataclass(frozen=True)
class SampledSoftmaxEstimator(Estimator):
    """The paper's eq. 2/3 estimator."""

    name: str = "sampled-softmax"

    def loss(self, pos_logit, neg_logits, logq, hit_mask, *,
             abs_mode=False):
        return sampled_softmax_loss(pos_logit, neg_logits, logq,
                                    abs_mode=abs_mode, hit_mask=hit_mask)


def _corrected_logistic(pos_logit, neg_logits, logq, hit_mask, abs_mode):
    """softplus(-pos) + sum softplus(neg - ln(m q)), hit slots zeroed when
    ``hit_mask`` is given.  Shared core of nce / sampled-logistic."""
    m = neg_logits.shape[-1]
    pos = transform_logits(pos_logit, abs_mode)
    neg = transform_logits(neg_logits, abs_mode) - (logq
                                                     + _log_m(m, neg_logits))
    per_slot = F.softplus(neg)
    if hit_mask is not None:
        per_slot = torch.where(hit_mask, 0.0, per_slot)
    return F.softplus(-pos) + torch.sum(per_slot, dim=-1)


@dataclasses.dataclass(frozen=True)
class NCEEstimator(Estimator):
    """Noise-contrastive estimation, negatives eq.-2-corrected; collided
    slots stay in, so ``hit_mask`` is deliberately ignored."""

    name: str = "nce"
    masks_hits: bool = False

    def loss(self, pos_logit, neg_logits, logq, hit_mask, *,
             abs_mode=False):
        return _corrected_logistic(pos_logit, neg_logits, logq, None,
                                   abs_mode)


@dataclasses.dataclass(frozen=True)
class SampledLogisticEstimator(Estimator):
    """NCE with accidental hits removed (zero mass AND zero gradient)."""

    name: str = "sampled-logistic"

    def loss(self, pos_logit, neg_logits, logq, hit_mask, *,
             abs_mode=False):
        return _corrected_logistic(pos_logit, neg_logits, logq, hit_mask,
                                   abs_mode)


@dataclasses.dataclass(frozen=True)
class FullSoftmaxEstimator(Estimator):
    """Dense oracle: exact eq. 1 cross entropy, no sampling at all."""

    name: str = "full"
    needs_sampling: bool = False

    def loss(self, pos_logit, neg_logits, logq, hit_mask, *,
             abs_mode=False):
        raise TypeError(
            "estimator 'full' is dense — route through dense_loss / "
            "loss_from_embeddings, not the sampled contract")

    def dense_loss(self, w, h, labels, *, abs_mode=False, bias=None):
        return full_softmax_loss(w, h, labels, abs_mode=abs_mode, bias=bias)


_REGISTRY: dict[str, Callable[[], Estimator]] = {
    "sampled-softmax": SampledSoftmaxEstimator,
    "nce": NCEEstimator,
    "sampled-logistic": SampledLogisticEstimator,
    "full": FullSoftmaxEstimator,
}


def estimator_names() -> list[str]:
    """Names accepted by make_estimator / cfg.estimator."""
    return sorted(_REGISTRY)


def make_estimator(name: str) -> Estimator:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown estimator '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def local_sampled_loss(est: Estimator, sampler, w: Tensor, h: Tensor,
                       labels: Tensor, state, m: int,
                       gen: torch.Generator | None, *, n_valid,
                       abs_mode: bool = False, bias: Tensor | None = None,
                       impl: str = "auto") -> Tensor:
    """The unsharded head path: hydrate (or rebuild from the head) the
    sampler's runtime state, draw negatives, dispatch the estimator.

    Sampling runs under ``torch.no_grad()`` on a detached head and detached
    h — the reference's ``stop_gradient``: no gradient ever reaches the
    sampler's kernels, which have no backward."""
    if not est.needs_sampling:
        return loss_from_embeddings(est, w, h, labels, None, None,
                                    abs_mode=abs_mode, bias=bias, impl=impl)
    with torch.no_grad():
        runtime = sampler.island_runtime(state, w.detach(), n_valid)
        neg_ids, logq = sampler.sample_batch(runtime, h.detach(), m, gen)
    return loss_from_embeddings(est, w, h, labels, neg_ids, logq,
                                abs_mode=abs_mode, bias=bias, impl=impl)


def loss_from_embeddings(
        est: Estimator, w: Tensor, h: Tensor, labels: Tensor,
        neg_ids: Tensor | None, logq: Tensor | None, *,
        abs_mode: bool = False, bias: Tensor | None = None,
        impl: str = "auto") -> Tensor:
    """Head-level dispatch: per-example loss (T,) from the embedding
    table."""
    if not est.needs_sampling:
        return est.dense_loss(w, h, labels, abs_mode=abs_mode, bias=bias)
    if neg_ids is None or logq is None:
        raise ValueError(
            f"estimator '{est.name}' needs sampled negatives: pass "
            "neg_ids and logq (or use estimator='full')")
    if est.name == "sampled-softmax":
        return sampled_softmax_from_embeddings(
            w, h, labels, neg_ids, logq, abs_mode=abs_mode, bias=bias,
            impl=impl)
    pos_logit, neg_logits, logq, hit = gather_pos_neg_logits(
        w, h, labels, neg_ids, logq, bias)
    return est.loss(pos_logit, neg_logits, logq, hit, abs_mode=abs_mode)
