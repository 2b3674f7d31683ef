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

The block, tree and rff samplers also update their runtime state in place
of a rebuild, after the rows of some ids changed (``update_rows``, the
paper's Fig. 1b sparse refresh).  The reference's runtime-form ``init`` /
``refresh`` have no counterpart: ``init_state`` / ``build_stats`` then
``hydrate`` give the same runtime state.

``logq`` is always the EXACT log-probability under the distribution sampled
from — what eq. 2 needs.  Randomness comes from the caller's
``torch.Generator``.

Ported families: ``uniform``, ``block-quadratic``,
``block-quadratic-shared`` (whose ``sample_batch`` waits for the
batch-shared slice), and the hierarchical families ``tree-quadratic`` (the
paper's §3.2 tree), ``rff`` (the tree over positive random-feature sums)
and ``midx`` (the quantized inverted multi-index).  The reference's other
registered names raise ``NotImplementedError`` naming the ``ROADMAP.md``
item that ports them.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable

import torch

from repro_torch.core import blocks, hierarchy, midx, tree
from repro_torch.core.kernel_fns import (
    SamplingKernel,
    quadratic_kernel,
    rff_directions,
)
from repro_torch.utils.misc import next_pow2

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

    def replace_stats(self, stats: dict[str, Tensor]) -> "SamplerState":
        return SamplerState(stats=stats, const=self.const)


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
        v_l, d = _head_dims(cfg, tp)
        r = self.proj_rank or d
        bs = self.block_size
        n_blocks_l = -(-v_l // bs)
        stats = {"z": _meta((tp * n_blocks_l, r, r)),
                 "cnt": _meta((tp * n_blocks_l,)),
                 "wq": _meta((tp * n_blocks_l, bs, r))}
        const = ({"proj": _meta((self.proj_rank, d))}
                 if self.proj_rank else {})
        return SamplerState(stats=stats, const=const)

    def update_rows(self, state, ids, w_new):
        """Runtime state after the rows ``ids`` (unique) became ``w_new``."""
        return {"stats": blocks.update_rows(state["stats"], ids, w_new,
                                            state["proj"]),
                "proj": state["proj"]}

    def sample_batch(self, state, h, m, gen):
        if self.shared:
            raise NotImplementedError(
                "block-quadratic-shared sampling is not ported yet (the "
                "batch-shared slice, ROADMAP.md A3)")
        return blocks.sample(state["stats"], self.kernel, h, m, gen,
                             state["proj"])


def _head_dims(cfg, tp: int) -> tuple[int, int]:
    """(vocab rows per shard, head width d)."""
    from repro_torch.models import api

    return -(-cfg.vocab_size // tp), api.hidden_width(cfg)


def _tree_dims(cfg, tp: int, leaf_size: int) -> tuple[int, int, int]:
    """(leaves per shard, padded leaf size, heap rows per shard)."""
    v_l, _ = _head_dims(cfg, tp)
    leaf = next_pow2(leaf_size)
    num_leaves_l = next_pow2(max(1, -(-v_l // leaf)))
    return num_leaves_l, leaf, hierarchy.heap_rows(num_leaves_l)


_meta = partial(torch.empty, dtype=torch.float32, device="meta")


@dataclasses.dataclass(frozen=True)
class TreeSampler(Sampler):
    """Paper §3.2: divide & conquer over a binary tree of Gram statistics
    (``core/tree.py``).  ``sample_batch`` is the level-synchronous batched
    descent; the train step carries the statistics heap-packed, like the
    block sampler's."""

    kernel: SamplingKernel = dataclasses.field(
        default_factory=quadratic_kernel)
    leaf_size: int | None = None
    proj_rank: int | None = None
    name: str = "tree-quadratic"
    carries_state = True

    def _carried_leaf(self, n: int, d: int) -> int:
        if self.leaf_size is not None:
            return self.leaf_size
        return tree.default_leaf_size(n, self.proj_rank or d)

    def init_const(self, gen, d):
        if self.proj_rank is None:
            return {}
        return {"proj": blocks.make_projection(gen, d, self.proj_rank)}

    def build_stats(self, w, n_valid, const):
        hs = tree.build(w, self.kernel,
                        next_pow2(self._carried_leaf(*w.shape)),
                        proj=const.get("proj"), n_valid=n_valid)
        z, cnt = hierarchy.to_heap(hs)
        return {"z": z, "cnt": cnt, "wq": hs.wq}

    def hydrate(self, state, n_valid):
        st = state.stats
        return {"stats": hierarchy.from_heap(st["z"], st["cnt"], st["wq"],
                                             n_valid),
                "proj": state.const.get("proj")}

    def state_shapes(self, cfg, tp=1):
        v_l, d = _head_dims(cfg, tp)
        r = self.proj_rank or d
        num_leaves_l, leaf, rows = _tree_dims(
            cfg, tp, self._carried_leaf(v_l, d))
        stats = {"z": _meta((tp * rows, r, r)),
                 "cnt": _meta((tp * rows,)),
                 "wq": _meta((tp * num_leaves_l, leaf, r))}
        const = ({"proj": _meta((self.proj_rank, d))}
                 if self.proj_rank else {})
        return SamplerState(stats=stats, const=const)

    def all_class_logq(self, state, h):
        """Exact per-class log q of the tree (test oracle, O(n r^2))."""
        return tree.all_class_logq(state["stats"], self.kernel, h,
                                   state["proj"])

    def update_rows(self, state, ids, w_new):
        """Runtime state after the rows ``ids`` (unique) became ``w_new``."""
        return {"stats": tree.update_path(state["stats"], self.kernel, ids,
                                          w_new, state["proj"]),
                "proj": state["proj"]}

    def sample_batch(self, state, h, m, gen):
        return tree.sample_batch(state["stats"], self.kernel, h, m, gen,
                                 state["proj"])


@dataclasses.dataclass(frozen=True)
class RFFSampler(Sampler):
    """Exp-kernel sampling through a positive-RFF feature-sum tree
    (``hierarchy.build_features`` / ``descend_features``): node masses are
    one product per level, the within-leaf categorical uses the EXACT exp
    kernel, so logq is exact under the distribution sampled.  The carried
    constant ``omega`` (D, d) is drawn once at init, like a projection."""

    dim: int = 128
    tau: float = 1.0
    leaf_size: int | None = None
    name: str = "rff"
    carries_state = True

    def _leaf_size(self, n: int, d: int) -> int:
        """ONE fallback formula for build_stats and state_shapes."""
        if self.leaf_size is not None:
            return self.leaf_size
        # Stop splitting once exact leaf scoring costs what a level does.
        return max(2, min(n, d))

    def init_const(self, gen, d):
        return {"omega": rff_directions(gen, self.dim, d)}

    def build_stats(self, w, n_valid, const):
        fs = hierarchy.build_features(
            w, next_pow2(self._leaf_size(*w.shape)), const["omega"],
            self.tau, n_valid=n_valid)
        f, aux = hierarchy.to_feature_heap(fs)
        return {"features": f, "aux": aux, "wq": fs.wq}

    def hydrate(self, state, n_valid):
        st = state.stats
        return {"stats": hierarchy.from_feature_heap(
                    st["features"], st["aux"], st["wq"], n_valid),
                "proj": state.const["omega"]}

    def state_shapes(self, cfg, tp=1):
        v_l, d = _head_dims(cfg, tp)
        num_leaves_l, leaf, rows = _tree_dims(cfg, tp,
                                              self._leaf_size(v_l, d))
        return SamplerState(
            stats={"features": _meta((tp * rows, self.dim)),
                   "aux": _meta((tp * rows,)),
                   "wq": _meta((tp * num_leaves_l, leaf, d))},
            const={"omega": _meta((self.dim, d))})

    def all_class_logq(self, state, h):
        """Exact per-class log q of the hierarchy (test oracle, O(n D))."""
        return hierarchy.all_class_logq_features(state["stats"],
                                                 state["proj"], self.tau, h)

    def update_rows(self, state, ids, w_new):
        """Runtime state after the rows ``ids`` (unique) became ``w_new``."""
        return {"stats": hierarchy.update_feature_rows(
                    state["stats"], ids, w_new, state["proj"], self.tau),
                "proj": state["proj"]}

    def sample_batch(self, state, h, m, gen):
        return hierarchy.descend_features(state["stats"], state["proj"],
                                          self.tau, h, m, gen)


@dataclasses.dataclass(frozen=True)
class MIDXSampler(Sampler):
    """Quantized inverted multi-index sampler (``core/midx.py``): stage 1
    draws a posting list from codeword-pair masses, stage 2 a member with
    the exact kernel; logq is the exact composed probability.  The carried
    state is the whole index, rebuilt on the refresh cadence; the
    codebooks are deterministic, so there are no constants."""

    kernel: SamplingKernel = dataclasses.field(
        default_factory=quadratic_kernel)
    codewords: int = 16
    codebooks: int = 2
    list_size: int | None = None
    name: str = "midx"
    carries_state = True

    def build_stats(self, w, n_valid, const):
        s = midx.build(w, codewords=self.codewords, codebooks=self.codebooks,
                       list_size=self.list_size, n_valid=n_valid)
        return {"c1": s.c1, "c2": s.c2, "codes": s.codes, "cnt": s.cnt,
                "perm": s.perm, "wq": s.wq}

    def hydrate(self, state, n_valid):
        st = state.stats
        return midx.MidxStats(
            c1=st["c1"], c2=st["c2"], codes=st["codes"], cnt=st["cnt"],
            perm=st["perm"], wq=st["wq"],
            n_valid=_n_valid_tensor(n_valid, st["wq"].device))

    def state_shapes(self, cfg, tp=1):
        v_l, d = _head_dims(cfg, tp)
        num_lists_l, leaf = midx.list_dims(v_l, d, self.list_size)
        k2 = self.codewords if self.codebooks == 2 else 1
        i32 = partial(torch.empty, dtype=torch.int32, device="meta")
        stats = {"c1": _meta((tp * self.codewords, d)),
                 "c2": _meta((tp * k2, d)),
                 "codes": i32((tp * num_lists_l, 2)),
                 "cnt": _meta((tp * num_lists_l,)),
                 "perm": i32((tp * num_lists_l * leaf,)),
                 "wq": _meta((tp * num_lists_l, leaf, d))}
        return SamplerState(stats=stats, const={})

    def all_class_logq(self, state, h):
        """Exact per-class log q of the composed two-stage distribution
        (test oracle, O(n d)), indexed by ORIGINAL class id."""
        return midx.all_class_logq(state, self.kernel, h)

    def sample_batch(self, state, h, m, gen):
        return midx.sample_batch(state, self.kernel, h, m, gen)


# --- registry ----------------------------------------------------------------


def _block_from_cfg(cfg, shared: bool) -> Sampler:
    return BlockSampler(kernel=quadratic_kernel(cfg.sampler_alpha),
                        block_size=cfg.sampler_block,
                        proj_rank=cfg.sampler_proj_rank, shared=shared)


def _tree_from_cfg(cfg) -> Sampler:
    return TreeSampler(kernel=quadratic_kernel(cfg.sampler_alpha),
                       leaf_size=cfg.sampler_block,
                       proj_rank=cfg.sampler_proj_rank)


def _rff_from_cfg(cfg) -> Sampler:
    if cfg.sampler_proj_rank:
        raise ValueError(
            "sampler='rff' ignores sampler_proj_rank — omega (rff_dim, d) "
            "IS the projection; set sampler_proj_rank=None")
    return RFFSampler(dim=cfg.rff_dim, tau=cfg.rff_tau,
                      leaf_size=cfg.sampler_block)


def _midx_from_cfg(cfg) -> Sampler:
    if cfg.sampler_proj_rank:
        raise ValueError(
            "sampler='midx' ignores sampler_proj_rank — the codebooks ARE "
            "the compression; set sampler_proj_rank=None")
    return MIDXSampler(kernel=quadratic_kernel(cfg.sampler_alpha),
                       codewords=cfg.midx_codewords,
                       codebooks=cfg.midx_codebooks,
                       list_size=cfg.sampler_block)


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
    "tree-quadratic": _Family(TreeSampler, _tree_from_cfg),
    "rff": _Family(RFFSampler, _rff_from_cfg),
    "midx": _Family(MIDXSampler, _midx_from_cfg),
}

#: the reference's other registered families -> the ROADMAP.md item that
#: ports them.
_NOT_PORTED: dict[str, str] = {
    "unigram": "A5", "softmax": "A5", "abs-softmax": "A5",
    "quadratic-oracle": "A5", "quartic-oracle": "A5",
    "rff-oracle": "A12", "midx-oracle": "A13", "tapas": "A14",
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
