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
        ids, logq = sampler.sample_batch(state, H, m, gen)  # (T,m)/shared(m,)

The block, tree and rff samplers also update their runtime state in place
of a rebuild, after the rows of some ids changed (``update_rows``, the
paper's Fig. 1b sparse refresh).  The reference's runtime-form ``init`` /
``refresh`` have no counterpart: ``init_state`` / ``build_stats`` then
``hydrate`` (or ``island_state`` for the families that carry nothing) give
the same runtime state; only the frequency samplers, which no train step
drives, keep an ``init``.

``logq`` is always the EXACT log-probability under the distribution sampled
from — what eq. 2 needs.  Randomness comes from the caller's
``torch.Generator``.

Distributions (paper §4.1.2 and Fig. 2, plus the rff, midx and tapas
families):
  uniform            q ∝ 1
  unigram            q ∝ class frequency
  bigram             q ∝ P(class | previous class)   (outside the registry)
  softmax (oracle)   q ∝ exp(o)
  abs-softmax oracle q ∝ exp(|o|)
  quadratic (oracle) q ∝ alpha o^2 + 1   — brute force, for bias studies
  quartic (oracle)   q ∝ alpha o^4 + 1
  tree-quadratic     the paper's §3.2 tree
  block-quadratic    the two-level form; ``-shared`` draws one set per batch
                     from the batch-summed kernel
  rff / rff-oracle   q ≈ exp(o / tau) through positive random features:
                     the feature-sum tree, and its brute-force twin
  midx / midx-oracle the quantized inverted multi-index, and the dense
                     categorical of its exact composed distribution
  tapas              two passes: a shared pool of P candidates from a
                     single-stage base, then m per example resampled from
                     q2 ∝ exp(o / tau) / pi over the pool; logq is the
                     composed log pi_j + log q2(j | pool)

The oracles draw a batch as ONE (T, n) product and one ``torch.multinomial``
(the reference vmaps a per-query ``sample``).
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable

import torch

from repro_torch.core import blocks, hierarchy, midx, tree
from repro_torch.core.blocks import categorical_rows
from repro_torch.core.kernel_fns import (
    SamplingKernel,
    quadratic_kernel,
    rff_directions,
    rff_kernel,
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
    #: True for multi-stage samplers whose runtime state needs the head
    #: table itself (tapas' pool re-scoring) on top of any carried state.
    two_stage: bool = False

    def sample(self, state: Any, h: Tensor, m: int, gen: torch.Generator
               ) -> tuple[Tensor, Tensor]:
        """m draws for one query h: (d,) -> (ids (m,), logq (m,))."""
        ids, logq = self.sample_batch(state, h[None], m, gen)
        if self.shares_negatives:  # one query's shared set is its own
            return ids, logq
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

    def shard_state_shapes(self, cfg, tp: int) -> SamplerState:
        """One shard's slice of ``state_shapes(cfg, tp)``: the statistics'
        leading (tp-stacked) axis divided by tp, the constants whole."""
        full = self.state_shapes(cfg, tp)
        return SamplerState(
            stats={k: torch.empty((v.shape[0] // tp, *v.shape[1:]),
                                  dtype=v.dtype, device="meta")
                   for k, v in full.stats.items()},
            const=dict(full.const))

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


def _multinomial_rows(logq: Tensor, m: int, gen: torch.Generator
                      ) -> tuple[Tensor, Tensor]:
    """m draws with replacement per row of a log-probability table (T, n)
    -> (ids (T, m) int64, their logq)."""
    ids = torch.multinomial(logq.exp(), m, replacement=True, generator=gen)
    return ids, torch.gather(logq, 1, ids)


def _normalized_log(log_s: Tensor, n_valid) -> Tensor:
    """log(s / sum s) over the last axis from log s, rows at or past
    ``n_valid`` (when given) at -inf."""
    if n_valid is not None:
        ok = torch.arange(log_s.shape[-1], device=log_s.device) < n_valid
        log_s = torch.where(ok, log_s, -math.inf)
    return torch.log_softmax(log_s, dim=-1)


@dataclasses.dataclass(frozen=True)
class UnigramSampler(Sampler):
    """q ∝ empirical class frequency (optionally distorted, as in
    word2vec).  Experiment-only: no train step drives it."""

    distortion: float = 1.0
    name: str = "unigram"

    def init(self, gen, w):
        n = w.shape[0]
        return {"logp": torch.full((n,), -math.log(n), device=w.device)}

    def set_counts(self, state, counts: Tensor):
        logits = self.distortion * torch.log(counts.float() + 1.0)
        return {"logp": torch.log_softmax(logits, dim=-1)}

    def sample_batch(self, state, h, m, gen):
        logp = state["logp"]
        ids = torch.multinomial(logp.exp(), h.shape[0] * m,
                                replacement=True, generator=gen)
        ids = ids.reshape(h.shape[0], m)
        return ids, logp[ids]


@dataclasses.dataclass(frozen=True)
class BigramSampler(Sampler):
    """q ∝ P(class | prev class); dense (n, n) table — paper-scale vocab
    only.  Conditions on a previous class id, not a hidden vector, so it
    stays out of the registry: use ``sample_ctx``."""

    name: str = "bigram"

    def init(self, gen, w):
        n = w.shape[0]
        if n > 65536:
            raise ValueError("the dense bigram table is for paper-scale "
                             f"vocabularies, got {n}")
        return {"logp": torch.full((n, n), -math.log(n), device=w.device)}

    def set_counts(self, state, counts: Tensor):
        logits = torch.log(counts.float() + 1.0)
        return {"logp": torch.log_softmax(logits, dim=-1)}

    def sample_ctx(self, state, prev_id, m: int, gen: torch.Generator):
        """m draws after the previous class ``prev_id`` (a 0-dim or (T,)
        id tensor, or an int) -> (ids, logq) of shape (m,) or (T, m)."""
        prev = torch.as_tensor(prev_id, device=state["logp"].device).long()
        logp = state["logp"][prev.reshape(-1)]
        ids, logq = _multinomial_rows(logp, m, gen)
        return ids.reshape(*prev.shape, m), logq.reshape(*prev.shape, m)


@dataclasses.dataclass(frozen=True)
class LogitOracleSampler(Sampler):
    """Brute-force sampler: computes ALL logits o = W h (O(nd)) and samples
    from q ∝ exp(log_score_fn(o)).  The paper's softmax / quadratic /
    quartic comparison points (Fig. 2) and the statistical test oracle.
    Scores are taken in the log domain (the reference's ``score_fn`` is
    its exp), so the exp families cannot overflow at large logits."""

    log_score_fn: Callable[[Tensor], Tensor] = lambda o: o
    name: str = "oracle"

    def logq_all(self, state, h):
        """Exact log q of every class: h (d,) -> (n,), or (T, d) -> (T, n)."""
        o = h.float() @ state["w"].float().T
        return _normalized_log(self.log_score_fn(o), state.get("n_valid"))

    def sample_batch(self, state, h, m, gen):
        return _multinomial_rows(self.logq_all(state, h), m, gen)

    def island_state(self, head_full, n_valid):
        return {"w": head_full, "n_valid": n_valid}


def softmax_oracle() -> LogitOracleSampler:
    return LogitOracleSampler(log_score_fn=lambda o: o, name="softmax")


def abs_softmax_oracle() -> LogitOracleSampler:
    return LogitOracleSampler(log_score_fn=torch.abs, name="abs-softmax")


def quadratic_oracle(alpha: float = 100.0) -> LogitOracleSampler:
    """log(alpha o^2 + 1), the log of ``quadratic_kernel(alpha)``."""
    return LogitOracleSampler(
        log_score_fn=lambda o: torch.log1p(alpha * torch.square(o)),
        name="quadratic-oracle")


def quartic_oracle(alpha: float = 1.0) -> LogitOracleSampler:
    """log(alpha o^4 + 1), the log of ``quartic_kernel(alpha)``."""
    return LogitOracleSampler(
        log_score_fn=lambda o: torch.log1p(
            alpha * torch.square(torch.square(o))),
        name="quartic-oracle")


@dataclasses.dataclass(frozen=True)
class BlockSampler(Sampler):
    """Two-level sampler (``core/blocks.py``).  shared=True draws one
    negative set per batch from the batch-summed kernel: ``sample_batch``
    then returns (m,) ids and logq."""

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

    def all_class_logq(self, state, h):
        """Exact per-class log q (test oracle): h (d,), or the batch (T, d)
        of the shared family."""
        return blocks.all_class_logq(state["stats"], self.kernel, h,
                                     state["proj"], shared=self.shared)

    def sample_batch(self, state, h, m, gen):
        if self.shared:
            return blocks.sample_shared(state["stats"], self.kernel, h, m,
                                        gen, state["proj"])
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


@dataclasses.dataclass(frozen=True)
class FeatureOracleSampler(Sampler):
    """Brute-force feature-space oracle: q_i ∝ <phi(h), phi(w_i)> over ALL
    classes (O(n D) a query) — the statistical reference of the rff
    family.  ``phi(w)`` is recomputed from the head at every rebuild."""

    kernel: SamplingKernel = dataclasses.field(default_factory=rff_kernel)
    name: str = "rff-oracle"

    def logq_all(self, state, h):
        """Exact log q of every class: h (d,) -> (n,), or (T, d) -> (T, n)."""
        s = self.kernel.phi(h.float()) @ self.kernel.phi(state["w"].float()).T
        return _normalized_log(torch.log(torch.clamp(s, min=1e-30)),
                               state.get("n_valid"))

    def sample_batch(self, state, h, m, gen):
        return _multinomial_rows(self.logq_all(state, h), m, gen)

    def island_state(self, head_full, n_valid):
        return {"w": head_full, "n_valid": n_valid}


def rff_oracle(dim: int = 512, tau: float = 1.0, seed: int = 0, *,
               omega: Tensor | None = None) -> FeatureOracleSampler:
    """``rff-oracle`` over ``kernel_fns.rff_kernel(dim, tau, seed)``; its
    directions are ``omega`` when given, else drawn from ``seed``."""
    return FeatureOracleSampler(kernel=rff_kernel(dim, tau, seed,
                                                  omega=omega))


@dataclasses.dataclass(frozen=True)
class MIDXOracleSampler(Sampler):
    """Brute-force midx twin: builds the SAME quantized index, then draws
    dense categoricals from its exact composed all-class distribution —
    the statistical reference ``"midx"`` must match draw for logq.  The
    train step rebuilds the index from the head every step."""

    kernel: SamplingKernel = dataclasses.field(
        default_factory=quadratic_kernel)
    codewords: int = 16
    codebooks: int = 2
    list_size: int | None = None
    name: str = "midx-oracle"

    def _build(self, w, n_valid=None):
        return midx.build(w, codewords=self.codewords,
                          codebooks=self.codebooks,
                          list_size=self.list_size, n_valid=n_valid)

    def logq_all(self, state, h):
        """Exact composed log q of every ORIGINAL class id: h (d,) ->
        (n_pad,), or (T, d) -> (T, n_pad)."""
        return midx.all_class_logq(state, self.kernel, h)

    def sample_batch(self, state, h, m, gen):
        return _multinomial_rows(self.logq_all(state, h), m, gen)

    def island_state(self, head_full, n_valid):
        return self._build(head_full, n_valid)


def pool_log_inclusion(logq1: Tensor, pool_size: int) -> Tensor:
    """log pi_j = log(1 - (1 - q1_j)^P): the probability class j appears in
    a pool of P i.i.d. draws from q1, given per-draw log q1 at the drawn
    classes.  Stable at both ends: q1 -> 0 gives log(P q1) (log1p + expm1,
    no cancellation), q1 -> 1 gives 0."""
    log1m_q1 = torch.log1p(-torch.clamp(torch.exp(logq1), max=1.0))
    return torch.log(-torch.expm1(pool_size * log1m_q1))


def _pool_multiplicity(pool_ids: Tensor, n: int) -> Tensor:
    """How often each slot's class occurs in its own pool: pool_ids (P,) or
    (R, P) -> the same shape, by one scatter-add (O(P), not P^2)."""
    rows = pool_ids.reshape(-1, pool_ids.shape[-1])
    flat = rows + n * torch.arange(rows.shape[0], device=rows.device)[:, None]
    counts = torch.bincount(flat.reshape(-1), minlength=rows.shape[0] * n)
    return counts[flat].reshape(pool_ids.shape)


@dataclasses.dataclass(frozen=True)
class TapasSampler(Sampler):
    """TAPAS-style two-pass mega-batch sampler (Bai et al. 2017, arXiv
    1707.03073).

    Pass 1 draws ``pool`` i.i.d. candidates through the single-stage
    ``base`` family; pass 2 re-scores the pool against each example's
    hidden state and resamples ``m`` slots per example from the per-slot
    categorical

        s_k = o_k / tau - log pi_k - log c_k

    with ``pi_k`` the pool-inclusion probability of slot k's class
    (``pool_log_inclusion``) and ``c_k`` its multiplicity in the pool.  The
    per-CLASS conditional is q2(j | pool) ∝ exp(o_j / tau) / pi_j, so the
    composed probability reported as ``logq`` is

        log pi_j + log q2(j | pool) = o_j / tau - logsumexp(s),

    a Horvitz-Thompson composition under which the eq. 2 partition estimate
    is exactly unbiased for any pool size and base q; at tau = 1 the
    corrected logit o_j - logq_j is constant across draws.

    Runtime state is ``{"base": <base runtime>, "w": (n, d) scoring table,
    "n_valid"}`` from ``island_runtime`` (``hydrate`` raises); the CARRIED
    state is the base family's, delegated verbatim."""

    base: Sampler = dataclasses.field(
        default_factory=lambda: BlockSampler(shared=True))
    pool: int = 1024
    tau: float = 1.0
    name: str = "tapas"
    two_stage = True

    def __post_init__(self):
        if getattr(self.base, "two_stage", False):
            raise ValueError(
                "tapas pools cannot nest: base must be a single-stage "
                f"sampler, got '{self.base.name}'")
        if self.pool <= 0:
            raise ValueError(f"tapas pool size must be > 0, got {self.pool}")
        if self.tau <= 0:
            raise ValueError(f"tapas tau must be > 0, got {self.tau}")

    # -- carried-state protocol: delegated to the base family ----------------
    @property
    def carries_state(self) -> bool:  # type: ignore[override]
        return self.base.carries_state

    def init_const(self, gen, d):
        return self.base.init_const(gen, d)

    def build_stats(self, w, n_valid, const):
        return self.base.build_stats(w, n_valid, const)

    def state_shapes(self, cfg, tp=1):
        return self.base.state_shapes(cfg, tp)

    def hydrate(self, state, n_valid):
        raise TypeError(
            "tapas pass 2 re-scores against the head table; build runtime "
            "state with island_runtime(state, head, n_valid)")

    def supports_head_loss(self) -> bool:
        return self.base.supports_head_loss()

    def island_runtime(self, state, head_full, n_valid):
        return {"base": self.base.island_runtime(state, head_full, n_valid),
                "w": head_full, "n_valid": n_valid}

    # -- sampling ------------------------------------------------------------
    def draw_pool(self, state, h: Tensor, gen: torch.Generator
                  ) -> tuple[Tensor, Tensor]:
        """Pass 1: (pool,) candidate ids + exact per-draw log q1.

        Batch-shared bases draw their native batch-summed shared set;
        per-example bases draw one pool from the mean query."""
        if self.base.shares_negatives:
            return self.base.sample_batch(state["base"], h, self.pool, gen)
        return self.base.sample(state["base"], torch.mean(h, dim=0),
                                self.pool, gen)

    def slot_logits(self, state, pool_ids: Tensor, logq1: Tensor,
                    h: Tensor) -> tuple[Tensor, Tensor]:
        """Pass 2's re-scored logits o = h w[pool]^T / tau and the per-slot
        categorical s = o - log pi - log c, each (T, P); pool_ids / logq1
        as in ``resample_from_pool``."""
        logpi = pool_log_inclusion(logq1, self.pool)
        mult = _pool_multiplicity(pool_ids, state["w"].shape[0])
        w = state["w"].float()
        if pool_ids.dim() == 1:
            o = (h.float() @ w[pool_ids].T) / self.tau
        else:
            o = torch.einsum("td,tpd->tp", h.float(), w[pool_ids]) / self.tau
        return o, o - (logpi + torch.log(mult.float()))

    def resample_from_pool(self, state, pool_ids: Tensor, logq1: Tensor,
                           h: Tensor, m: int, gen: torch.Generator
                           ) -> tuple[Tensor, Tensor]:
        """Pass 2: (T, m) ids + the composed pool x resample logq.

        pool_ids / logq1: one (P,) pool for the whole batch, or (T, P), one
        pool per row of h (independent repetitions)."""
        o, s = self.slot_logits(state, pool_ids, logq1, h)
        slots = categorical_rows(gen, s, m)
        logq = (torch.gather(o, 1, slots)
                - torch.logsumexp(s, dim=-1, keepdim=True))
        ids = (pool_ids[slots] if pool_ids.dim() == 1
               else torch.gather(pool_ids, 1, slots))
        return ids, logq

    def sample_batch(self, state, h, m, gen):
        pool_ids, logq1 = self.draw_pool(state, h, gen)
        return self.resample_from_pool(state, pool_ids, logq1, h, m, gen)


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


def _midx_oracle_from_cfg(cfg) -> Sampler:
    return MIDXOracleSampler(kernel=quadratic_kernel(cfg.sampler_alpha),
                             codewords=cfg.midx_codewords,
                             codebooks=cfg.midx_codebooks,
                             list_size=cfg.sampler_block)


def _tapas_from_cfg(cfg) -> Sampler:
    if cfg.tapas_base == "tapas":
        raise ValueError(
            "tapas pools cannot nest: cfg.tapas_base must name a "
            "single-stage family")
    fam = _lookup(cfg.tapas_base)
    base = fam.from_cfg(cfg) if fam.from_cfg is not None else fam.ctor()
    return TapasSampler(base=base, pool=cfg.tapas_pool, tau=cfg.tapas_tau)


@dataclasses.dataclass(frozen=True)
class _Family:
    ctor: Callable[..., Sampler]
    #: cfg -> Sampler; None means plain ``ctor()`` (no cfg-derived knobs).
    from_cfg: Callable[..., Sampler] | None = None


_REGISTRY: dict[str, _Family] = {
    "uniform": _Family(UniformSampler),
    "unigram": _Family(UnigramSampler),
    "softmax": _Family(softmax_oracle),
    "abs-softmax": _Family(abs_softmax_oracle),
    "quadratic-oracle": _Family(
        quadratic_oracle, lambda cfg: quadratic_oracle(cfg.sampler_alpha)),
    "quartic-oracle": _Family(quartic_oracle),
    "rff-oracle": _Family(rff_oracle),
    "tree-quadratic": _Family(TreeSampler, _tree_from_cfg),
    "block-quadratic": _Family(
        BlockSampler, partial(_block_from_cfg, shared=False)),
    "block-quadratic-shared": _Family(
        partial(BlockSampler, shared=True),
        partial(_block_from_cfg, shared=True)),
    "rff": _Family(RFFSampler, _rff_from_cfg),
    "midx": _Family(MIDXSampler, _midx_from_cfg),
    "midx-oracle": _Family(MIDXOracleSampler, _midx_oracle_from_cfg),
    "tapas": _Family(TapasSampler, _tapas_from_cfg),
}

#: registered families that do NOT satisfy the Sampler protocol.
_EXCLUDED: dict[str, str] = {
    "bigram": "BigramSampler does not satisfy the Sampler protocol: it "
              "conditions on a discrete previous-class id, not a hidden "
              "vector.  Construct BigramSampler() directly and use "
              "sample_ctx(state, prev_id, m, gen).",
}


def sampler_names() -> list[str]:
    """Names accepted by make_sampler / cfg.sampler."""
    return sorted(_REGISTRY)


def _lookup(name: str) -> _Family:
    if name in _EXCLUDED:
        raise ValueError(_EXCLUDED[name])
    if name not in _REGISTRY:
        raise KeyError(f"unknown sampler '{name}'; have {sampler_names()}")
    return _REGISTRY[name]


def make_sampler(name: str, **kwargs) -> Sampler:
    return _lookup(name).ctor(**kwargs)


def sampler_from_config(cfg) -> Sampler:
    """The cfg-aware constructor the train step uses."""
    fam = _lookup(cfg.sampler)
    return fam.from_cfg(cfg) if fam.from_cfg is not None else fam.ctor()
