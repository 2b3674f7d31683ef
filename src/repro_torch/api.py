"""``repro_torch.api`` — the facade over the whole sampled-softmax head
(``repro.api``).

Everything the head does — adaptive negative sampling, the corrected loss
estimator, the fused head kernels, serving-time top-k retrieval — sits
behind ONE object built from ONE config:

    import torch
    from repro_torch.api import SoftmaxHead
    from repro_torch.configs import get_config

    cfg = get_config("youtube-dnn").reduced()     # sampler/estimator knobs
    head = SoftmaxHead(cfg)                       # validates cfg up front

    gen    = torch.Generator().manual_seed(0)     # the reference's key
    state  = head.init(gen, w)                    # SamplerState
    state  = head.refresh(state, w)               # adapt to new params
    losses = head.loss(w, h, labels, state=state, key=gen)   # (T,)
    index  = head.export_index(w)                 # serving MIPS index
    ids, logits = head.decode_topk(w, h, k=10, index=index)

``w`` is any (n, d) class-embedding table and ``h`` any (T, d) batch of
last-hidden-layer vectors; the facade never touches the backbone.  Every
tensor it makes lives on ``w``'s device.  Parameter names, order and
defaults are the reference's; a ``key`` is a ``torch.Generator``.  The
train-step factories and ``fit`` (re-exported here) consume the same
config and carry the same ``SamplerState``.

On a ``(data, model)`` mesh (a ``ShardCtx``) ``w`` is this rank's vocab
shard of the head: ``export_index(w, ctx)`` builds the rank's shard of
the index and ``decode_topk(..., ctx=ctx)`` merges the shards' top-k over
the model group (dense: through ``serve.engine.decode_topk``, as the
reference's facade does).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import estimators as _estimators
from repro_torch.core import samplers as _samplers
from repro_torch.core.estimators import (  # noqa: F401  (re-export)
    Estimator,
    estimator_names,
    make_estimator,
)
from repro_torch.core.samplers import (  # noqa: F401  (re-export)
    Sampler,
    SamplerState,
    make_sampler,
    sampler_from_config,
    sampler_names,
)
from repro_torch.serve import engine, retrieval
from repro_torch.sharding import rules
from repro_torch.train.loop import fit  # noqa: F401  (re-export)
from repro_torch.train.step import (  # noqa: F401  (re-export)
    TrainState,
    abstract_train_state,
    export_retrieval_index,
    init_train_state,
    make_train_step,
)

Tensor = torch.Tensor

__all__ = [
    "SoftmaxHead",
    # state + registries
    "SamplerState",
    "Sampler",
    "Estimator",
    "make_sampler",
    "sampler_from_config",
    "sampler_names",
    "make_estimator",
    "estimator_names",
    # training entry points (same config, same SamplerState)
    "TrainState",
    "make_train_step",
    "init_train_state",
    "abstract_train_state",
    "export_retrieval_index",
    "fit",
]


@dataclasses.dataclass(frozen=True)
class SoftmaxHead:
    """Sampler + estimator + head-kernel dispatch bundled behind one config.
    Construction validates the config: unknown sampler / estimator /
    head_impl names and inconsistent knobs raise here."""

    cfg: ArchConfig

    def __post_init__(self):
        self.cfg.validate()

    # -- components (constructed on demand; samplers are stateless) ---------
    @property
    def sampler(self) -> Sampler:
        return _samplers.sampler_from_config(self.cfg)

    @property
    def estimator(self) -> Estimator:
        return _estimators.make_estimator(self.cfg.estimator)

    def _check_table(self, w: Tensor) -> None:
        """Fail fast on a table smaller than the configured vocab — ids
        up to vocab_size would index past it and logq would be reported
        over the wrong n.  MORE rows than vocab_size are fine: that is a
        padded table; n_valid masks the padding everywhere."""
        if w.shape[0] < self.cfg.vocab_size:
            raise ValueError(
                f"class table has {w.shape[0]} rows but cfg.vocab_size is "
                f"{self.cfg.vocab_size}; pass a table covering the full "
                "vocab (padding rows beyond vocab_size are allowed)")

    # -- state lifecycle -----------------------------------------------------
    @torch.no_grad()
    def init(self, key: torch.Generator, w: Tensor) -> SamplerState:
        """Carried sampler state from the class-embedding table ``w``; the
        constants (a projection, rff's directions) are drawn from ``key``.
        Empty for samplers that carry nothing."""
        self._check_table(w)
        return self.sampler.init_state(key, w.detach(),
                                       n_valid=self.cfg.vocab_size)

    @torch.no_grad()
    def refresh(self, state: SamplerState, w: Tensor) -> SamplerState:
        """Rebuild the adaptive statistics against the current ``w``; the
        run-lifetime constants are kept."""
        sampler = self.sampler
        if not sampler.carries_state:
            return state
        self._check_table(w)
        return state.replace_stats(sampler.build_stats(
            w.detach(), self.cfg.vocab_size, state.const))

    # -- sampling + loss -----------------------------------------------------
    @torch.no_grad()
    def sample(self, state: SamplerState, h: Tensor, key: torch.Generator,
               m: int | None = None, *, w: Tensor | None = None
               ) -> tuple[Tensor, Tensor]:
        """Draw negatives for a batch: ids + EXACT log q ((T, m), or (m,)
        for batch-shared families).  Carrying samplers only — the
        non-carrying families derive their runtime state from ``w`` at loss
        time (use ``loss(...)``).  Two-stage samplers (tapas) also need the
        class table ``w`` itself: pass 2 re-scores the pool against live
        logits."""
        sampler = self.sampler
        if sampler.two_stage:
            if w is None:
                raise ValueError(
                    f"sampler '{sampler.name}' re-scores its candidate "
                    "pool against the class table; pass w=")
            self._check_table(w)
        elif not sampler.carries_state:
            raise TypeError(
                f"sampler '{sampler.name}' carries no state; draw through "
                "loss(...)")
        m = m if m is not None else self.cfg.m_negatives
        if m <= 0:
            raise ValueError(f"m must be positive, got {m}")
        if sampler.two_stage:
            runtime = sampler.island_runtime(state, w.detach(),
                                             self.cfg.vocab_size)
        else:
            runtime = sampler.hydrate(state, self.cfg.vocab_size)
        return sampler.sample_batch(runtime, h.detach(), m, key)

    def loss(self, w: Tensor, h: Tensor, labels: Tensor, *,
             state: SamplerState | None = None,
             key: torch.Generator | None = None,
             bias: Tensor | None = None) -> Tensor:
        """Per-example estimator loss (T,), differentiable in ``w``, ``h``
        and ``bias``.

        Sampled estimators draw ``cfg.m_negatives`` fresh negatives from
        ``key`` (without gradient, as in training) and route the default
        estimator through the fused head per ``cfg.head_impl``;
        ``estimator='full'`` needs neither ``state`` nor ``key``.  The
        train step's path exactly: both call
        ``core.estimators.local_sampled_loss``."""
        est = self.estimator
        cfg = self.cfg
        self._check_table(w)
        if est.needs_sampling:
            if key is None:
                raise ValueError(
                    "sampled estimators need an explicit `key`")
            if self.sampler.carries_state and state is None:
                raise ValueError(
                    f"sampler '{self.sampler.name}' carries state; pass "
                    "state=head.init(key, w)")
        return _estimators.local_sampled_loss(
            est, self.sampler, w, h, labels, state, cfg.m_negatives, key,
            n_valid=cfg.vocab_size, abs_mode=cfg.abs_softmax, bias=bias,
            impl=cfg.head_impl)

    # -- serving -------------------------------------------------------------
    def export_index(self, w: Tensor, ctx: Any = None,
                     leaf_size: int | None = None
                     ) -> retrieval.RetrievalIndex:
        """Pack ``w`` into the hierarchy-backed MIPS index (on a mesh
        ``ctx`` this rank's shard of it, from its head shard ``w``)."""
        if not rules.on_mesh(ctx):
            self._check_table(w)
        return retrieval.build_index(w.detach(), ctx, leaf_size=leaf_size,
                                     vocab_size=self.cfg.vocab_size)

    def decode_topk(self, w: Tensor, h: Tensor, k: int, *,
                    index: Any = None, beam: int | None = None,
                    ctx: Any = None) -> tuple[Tensor, Tensor]:
        """Top-k (ids, logits) per query: beam retrieval through ``index``
        when given (exact at full beam), dense scoring otherwise.  With a
        mesh ``ctx`` the dense path runs vocab-sharded through
        ``engine.decode_topk`` (``w`` this rank's head shard: per-shard
        top-k and one (T, k) all-gather, never a (T, n) logit tensor)."""
        if index is not None:
            return retrieval.decode_topk(index, h, k, beam, ctx)
        if beam is not None:
            raise ValueError(
                "beam is a retrieval-index knob; without an index the "
                "dense path scores every class — pass "
                "index=head.export_index(w) to use a beam")
        if rules.on_mesh(ctx):
            return engine.decode_topk(self.cfg, ctx, w, h, k)
        self._check_table(w)
        return retrieval.dense_topk(w, h, k, n_valid=self.cfg.vocab_size)
