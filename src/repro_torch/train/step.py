"""The train step, unsharded (``repro.train.step`` with ``mesh=None``).

Data flow per step (youtube-dnn):

  batch --> tower --> h (B, d)
  sampler-stat refresh from the head on the cadence
      (``cfg.sampler_refresh_every``; ``zstats`` on the card)
  per-example kernel sampling of m negatives   [``block_scores`` root step,
      ``leaf_scores`` within-block step], under ``torch.no_grad()``
  estimator-routed corrected loss               [eq. 2-3 through the fused
      head: ``fused_lse`` forward, ``fused_lse_bwd`` backward]
  loss --> autograd --> clip + AdamW, applied to the parameters in place

Sampler statistics are carried in ``TrainState.sampler_state``, a
``SamplerState`` owned by the sampler.  The correction always uses the
statistics actually sampled from, so staleness costs bias-of-q only.

The refresh branches on the host (the reference computes both sides and
selects with ``jnp.where``; the result is the same).  A mesh, or
``refresh_mode="overlap"``, raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import estimators
from repro_torch.core.samplers import (
    SamplerState,
    empty_state,
    sampler_from_config,
)
from repro_torch.models import api
from repro_torch.optim.transform import GradientTransform, apply_updates
from repro_torch.serve import retrieval
from repro_torch.utils.misc import fold_in, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    """Carried training state.

    ``params`` is the model (an ``nn.Module``, updated in place by each
    step); ``opt_state`` the optimizer's state; ``sampler_state`` the
    sampler-owned ``SamplerState``; ``step`` the host step count."""

    params: torch.nn.Module
    opt_state: Any
    sampler_state: SamplerState
    step: int


def _require_sync(cfg: ArchConfig, ctx) -> None:
    retrieval.require_unsharded(ctx)
    if cfg.refresh_mode == "overlap":
        raise NotImplementedError(
            "refresh_mode='overlap' is not ported yet (the refresh-island "
            "slice, ROADMAP.md A9)")


def param_dict(model: torch.nn.Module) -> dict[str, Tensor]:
    """The model's parameters by name: what the optimizers update."""
    return dict(model.named_parameters())


def make_refresh_fn(cfg: ArchConfig, ctx=None
                    ) -> Callable[[Tensor, SamplerState], SamplerState]:
    """Unconditional sampler-stat rebuild from the head table.  A no-op
    (state passes through) for stateless samplers or dense estimators."""
    retrieval.require_unsharded(ctx)
    cfg.validate()
    sampler = sampler_from_config(cfg)
    estimator = estimators.make_estimator(cfg.estimator)
    carries_stats = sampler.carries_state and estimator.needs_sampling

    @torch.no_grad()
    def refresh_fn(head: Tensor, sampler_state: SamplerState
                   ) -> SamplerState:
        if not carries_stats:
            return sampler_state
        stats = sampler.build_stats(head.detach(), cfg.vocab_size,
                                    sampler_state.const)
        return SamplerState(stats=stats, const=dict(sampler_state.const))

    refresh_fn.carries_stats = carries_stats
    return refresh_fn


def _split_microbatches(batch: dict, mu: int) -> list[dict]:
    """(B, ...) -> mu microbatches of B/mu rows, row j of microbatch i being
    row j*mu + i, as the reference interleaves them."""
    b = next(iter(batch.values())).shape[0]
    assert b % mu == 0, f"batch {b} % microbatches {mu} != 0"
    return [{k: x[i::mu] for k, x in batch.items()} for i in range(mu)]


def make_train_step(cfg: ArchConfig, ctx, opt: GradientTransform,
                    aux_coef: float = 0.01
                    ) -> Callable[[TrainState, dict, torch.Generator],
                                  tuple[TrainState, dict]]:
    """``train_step(state, batch, gen) -> (state, metrics)``; ``gen``
    draws the step's negatives."""
    _require_sync(cfg, ctx)
    cfg.validate()
    sampler = sampler_from_config(cfg)
    estimator = estimators.make_estimator(cfg.estimator)
    m = cfg.m_negatives
    refresh_fn = make_refresh_fn(cfg, ctx)
    every = max(cfg.sampler_refresh_every, 1)

    def loss_fn(model, mb, sstate, gen):
        h2d, labels, aux = api.backbone_hidden(model, mb, cfg)
        head = api.head_table(model, cfg)
        lsum = torch.sum(estimators.local_sampled_loss(
            estimator, sampler, head, h2d, labels, sstate, m, gen,
            n_valid=cfg.vocab_size, abs_mode=cfg.abs_softmax,
            impl=cfg.head_impl))
        loss = lsum / h2d.shape[0]
        return loss + aux_coef * aux, loss, aux

    def grads_of(model, mb, sstate, gen):
        params = param_dict(model)
        total, loss, aux = loss_fn(model, mb, sstate, gen)
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        return total, loss, aux, {
            k: g if g is not None else torch.zeros_like(p)
            for (k, p), g in zip(params.items(), grads)}

    def train_step(state: TrainState, batch: dict, gen: torch.Generator
                   ) -> tuple[TrainState, dict]:
        sstate = state.sampler_state
        if state.step % every == 0:
            sstate = refresh_fn(api.head_table(state.params, cfg), sstate)
        mu = max(cfg.microbatches, 1)
        if mu == 1:
            total, loss, aux, grads = grads_of(state.params, batch, sstate,
                                               gen)
        else:
            total = loss = aux = 0.0
            grads = None
            for mb in _split_microbatches(batch, mu):
                t_i, l_i, a_i, g_i = grads_of(state.params, mb, sstate, gen)
                total, loss, aux = total + t_i, loss + l_i, aux + a_i
                grads = g_i if grads is None else {
                    k: grads[k] + g.float() for k, g in g_i.items()}
            total, loss, aux = total / mu, loss / mu, aux / mu
            grads = {k: g / mu for k, g in grads.items()}
        params = param_dict(state.params)
        updates, opt_state = opt.update(grads, state.opt_state, params)
        apply_updates(params, updates)
        new_state = TrainState(
            params=state.params, opt_state=opt_state,
            sampler_state=sstate if refresh_fn.carries_stats
            else state.sampler_state,
            step=state.step + 1)
        metrics = {"loss": loss.detach(), "aux_loss": aux.detach(),
                   "total_loss": total.detach()}
        return new_state, metrics

    return train_step


def export_retrieval_index(state: TrainState, cfg: ArchConfig, ctx=None,
                           leaf_size: int | None = None
                           ) -> retrieval.RetrievalIndex:
    """Packed serving index from a trained state: UNPROJECTED statistics
    of the current head table (``serve/retrieval.py::build_index``), never
    the carried sampler state, which may be projected and is one update
    stale."""
    head = api.head_table(state.params, cfg).detach()
    return retrieval.build_index(head, ctx, leaf_size=leaf_size,
                                 vocab_size=cfg.vocab_size)


def init_train_state(gen: torch.Generator, cfg: ArchConfig, ctx,
                     opt: GradientTransform,
                     device: str | torch.device | None = None) -> TrainState:
    """Concrete init on ``device`` (the card unless ``device="cpu"``):
    weights drawn from ``gen``, the optimizer's zero state, and the
    sampler's statistics built from the initial head.  The sampler's
    constants come from a generator seeded off ``gen``'s seed, as the
    reference folds 7 into its key."""
    _require_sync(cfg, ctx)
    cfg.validate()
    dev = resolve_device(device)
    sampler = sampler_from_config(cfg)
    estimator = estimators.make_estimator(cfg.estimator)
    model = api.init_params(cfg, gen, device=dev)
    opt_state = opt.init(param_dict(model))
    sstate = empty_state()
    if sampler.carries_state and estimator.needs_sampling:
        const_gen = torch.Generator(dev).manual_seed(
            fold_in(gen.initial_seed(), 7))
        with torch.no_grad():
            sstate = sampler.init_state(const_gen,
                                        api.head_table(model, cfg).detach(),
                                        n_valid=cfg.vocab_size)
    return TrainState(params=model, opt_state=opt_state,
                      sampler_state=sstate, step=0)
