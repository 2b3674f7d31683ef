"""Negative-sampler interface and registry (``repro.core.samplers``).

Samplers are stateless objects; their statistics live in explicit state.
Two state forms, as in the reference:

  * the CARRIED state — one ``SamplerState`` of flat tensor dicts that the
    train step stores in ``TrainState``; the sampler builds it
    (``build_stats``), declares its shapes (``state_shapes``, as ``meta``
    tensors) and turns it into
  * the RUNTIME state that ``sample`` / ``sample_batch`` consume
    (``hydrate``, or ``island_runtime`` for any family):

        ids, logq = sampler.sample(state, h, m, gen)        # one query (m,)
        ids, logq = sampler.sample_batch(state, H, m, gen)  # (T, m)

The reference's runtime-form ``init`` / ``refresh`` (used by its
``SoftmaxHead`` facade) arrive with that facade (ROADMAP.md A11).

``logq`` is always the EXACT log-probability under the distribution sampled
from — what eq. 2 needs.  Randomness comes from the caller's
``torch.Generator``.

Ported families: ``uniform``, ``block-quadratic`` and
``block-quadratic-shared`` (whose ``sample_batch`` waits for the
batch-shared slice).  The reference's other registered names raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports them.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable

import torch

from repro_torch.core import blocks
from repro_torch.core.kernel_fns import SamplingKernel, quadratic_kernel

Tensor = torch.Tensor


@dataclasses.dataclass
class SamplerState:
    """The carried sampler state, owned by the sampler.

    ``stats`` — adaptive statistics rebuilt on the refresh cadence.
    ``const`` — run-lifetime constants drawn once at init and never
    refreshed (the JL projection ``proj``).  Both are flat
    ``{name: tensor}`` dicts whose keys are private to the sampler family.
    Non-carrying samplers use the empty state."""

    stats: dict[str, Tensor]
    const: dict[str, Tensor]


def empty_state() -> SamplerState:
    return SamplerState(stats={}, const={})


def _n_valid_tensor(n_valid, device) -> Tensor:
    return torch.as_tensor(n_valid, dtype=torch.int32, device=device)


class Sampler:
    """Base class; subclasses override ``sample_batch`` and, for
    train-step citizens, the carried-state protocol."""

    name: str = "base"
    #: True when sample_batch returns one shared (m,) set instead of (T, m).
    shares_negatives: bool = False
    #: True when the train step carries and refreshes this sampler's
    #: statistics in TrainState.
    carries_state: bool = False

    def sample(self, state: Any, h: Tensor, m: int, gen: torch.Generator
               ) -> tuple[Tensor, Tensor]:
        """m draws for one query h: (d,) -> (ids (m,), logq (m,))."""
        ids, logq = self.sample_batch(state, h[None], m, gen)
        return ids[0], logq[0]

    def sample_batch(self, state: Any, h: Tensor, m: int,
                     gen: torch.Generator) -> tuple[Tensor, Tensor]:
        """m draws per query of h: (T, d) -> (ids (T, m), logq (T, m))."""
        raise NotImplementedError

    # --- carried-state protocol ---------------------------------------------

    def init_const(self, gen: torch.Generator, d: int) -> dict[str, Tensor]:
        """Run-lifetime constants (the projection); ``d`` = head width."""
        return {}

    def init_state(self, gen: torch.Generator, w: Tensor, *,
                   n_valid: Tensor | int | None = None) -> SamplerState:
        """Carried state built from a full head table."""
        if not self.carries_state:
            return empty_state()
        if n_valid is None:
            n_valid = w.shape[0]
        const = self.init_const(gen, w.shape[1])
        return SamplerState(stats=self.build_stats(w, n_valid, const),
                            const=const)

    def build_stats(self, w: Tensor, n_valid, const: dict[str, Tensor]
                    ) -> dict[str, Tensor]:
        """Fresh carried statistics from a head table."""
        raise TypeError(f"sampler '{self.name}' carries no statistics")

    def hydrate(self, state: SamplerState, n_valid) -> Any:
        """Carried state -> the runtime state ``sample_batch`` consumes."""
        if not self.carries_state:
            raise TypeError(
                f"sampler '{self.name}' carries no statistics; its runtime "
                "state comes from island_state(head, n_valid)")
        raise NotImplementedError

    def state_shapes(self, cfg, tp: int = 1) -> SamplerState:
        """Shapes of the carried tensors, as ``meta`` tensors."""
        if not self.carries_state:
            return empty_state()
        raise NotImplementedError

    def island_state(self, head_full: Tensor, n_valid) -> Any:
        """Runtime state of a NON-carrying sampler, rebuilt from the head."""
        raise TypeError(
            f"sampler '{self.name}' is unsupported in the train step")

    def island_runtime(self, state: SamplerState, head_full: Tensor,
                       n_valid) -> Any:
        """ONE entry point for the train step's runtime state: carrying
        samplers hydrate their carried state, the others rebuild from the
        (detached) head."""
        if self.carries_state:
            return self.hydrate(state, n_valid)
        return self.island_state(head_full, n_valid)

    def supports_head_loss(self) -> bool:
        """True when the train step can drive this sampler."""
        return (self.carries_state
                or type(self).island_state is not Sampler.island_state)


@dataclasses.dataclass(frozen=True)
class UniformSampler(Sampler):
    name: str = "uniform"

    def sample_batch(self, state, h, m, gen):
        n = int(state["n"])
        ids = torch.randint(0, n, (h.shape[0], m), generator=gen,
                            device=h.device)
        logq = torch.full((h.shape[0], m), -math.log(n),
                          dtype=torch.float32, device=h.device)
        return ids, logq

    def island_state(self, head_full, n_valid):
        # Sample over the VALID rows only (no q-mass on padding rows).
        return {"n": max(int(n_valid), 1)}


@dataclasses.dataclass(frozen=True)
class BlockSampler(Sampler):
    """Two-level sampler (``core/blocks.py``).  shared=True draws one
    negative set per batch from the batch-summed kernel — the batch-shared
    slice; until then its ``sample_batch`` raises."""

    kernel: SamplingKernel = dataclasses.field(
        default_factory=quadratic_kernel)
    block_size: int = 256
    proj_rank: int | None = None
    shared: bool = False
    name: str = "block-quadratic"
    carries_state = True

    @property
    def shares_negatives(self) -> bool:  # type: ignore[override]
        return self.shared

    def init_const(self, gen, d):
        if self.proj_rank is None:
            return {}
        return {"proj": blocks.make_projection(gen, d, self.proj_rank)}

    def build_stats(self, w, n_valid, const):
        s = blocks.build(w, self.block_size, const.get("proj"), n_valid)
        return {"z": s.z, "cnt": s.cnt, "wq": s.wq}

    def hydrate(self, state, n_valid):
        st = state.stats
        return {"stats": blocks.BlockStats(
                    st["z"], st["cnt"], st["wq"],
                    _n_valid_tensor(n_valid, st["wq"].device)),
                "proj": state.const.get("proj")}

    def state_shapes(self, cfg, tp=1):
        v_l = -(-cfg.vocab_size // tp)
        d = _hidden_width(cfg)
        r = self.proj_rank or d
        bs = self.block_size
        n_blocks_l = -(-v_l // bs)
        meta = partial(torch.empty, dtype=torch.float32, device="meta")
        stats = {"z": meta((tp * n_blocks_l, r, r)),
                 "cnt": meta((tp * n_blocks_l,)),
                 "wq": meta((tp * n_blocks_l, bs, r))}
        const = ({"proj": meta((self.proj_rank, d))}
                 if self.proj_rank else {})
        return SamplerState(stats=stats, const=const)

    def sample_batch(self, state, h, m, gen):
        if self.shared:
            raise NotImplementedError(
                "block-quadratic-shared sampling is not ported yet (the "
                "batch-shared slice, ROADMAP.md A3)")
        return blocks.sample(state["stats"], self.kernel, h, m, gen,
                             state["proj"])


def _hidden_width(cfg) -> int:
    from repro_torch.models import api

    return api.hidden_width(cfg)


# --- registry ----------------------------------------------------------------


def _block_from_cfg(cfg, shared: bool) -> Sampler:
    return BlockSampler(kernel=quadratic_kernel(cfg.sampler_alpha),
                        block_size=cfg.sampler_block,
                        proj_rank=cfg.sampler_proj_rank, shared=shared)


@dataclasses.dataclass(frozen=True)
class _Family:
    ctor: Callable[..., Sampler]
    #: cfg -> Sampler; None means plain ``ctor()`` (no cfg-derived knobs).
    from_cfg: Callable[..., Sampler] | None = None


_REGISTRY: dict[str, _Family] = {
    "uniform": _Family(UniformSampler),
    "block-quadratic": _Family(
        BlockSampler, partial(_block_from_cfg, shared=False)),
    "block-quadratic-shared": _Family(
        partial(BlockSampler, shared=True),
        partial(_block_from_cfg, shared=True)),
}

#: the reference's other registered families -> the ROADMAP.md item that
#: ports them.
_NOT_PORTED: dict[str, str] = {
    "unigram": "A5", "softmax": "A5", "abs-softmax": "A5",
    "quadratic-oracle": "A5", "quartic-oracle": "A5",
    "tree-quadratic": "A3 and A5", "rff": "A12", "rff-oracle": "A12",
    "midx": "A13", "midx-oracle": "A13", "tapas": "A14",
}

#: registered families that do NOT satisfy the Sampler protocol.
_EXCLUDED: dict[str, str] = {
    "bigram": "BigramSampler does not satisfy the Sampler protocol: it "
              "conditions on a discrete previous-class id, not a hidden "
              "vector.",
}


def sampler_names() -> list[str]:
    """Names accepted by make_sampler / cfg.sampler (ported families)."""
    return sorted(_REGISTRY)


def _lookup(name: str) -> _Family:
    if name in _EXCLUDED:
        raise ValueError(_EXCLUDED[name])
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"sampler '{name}' is not ported yet (ROADMAP.md "
            f"{_NOT_PORTED[name]}); ported: {sampler_names()}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown sampler '{name}'; have {sampler_names()}")
    return _REGISTRY[name]


def make_sampler(name: str, **kwargs) -> Sampler:
    return _lookup(name).ctor(**kwargs)


def sampler_from_config(cfg) -> Sampler:
    """The cfg-aware constructor the train step uses."""
    fam = _lookup(cfg.sampler)
    return fam.from_cfg(cfg) if fam.from_cfg is not None else fam.ctor()
