"""Two-level kernel sampler (``repro.core.blocks``): ONE dense root step
that scores every block, then ONE exact leaf step inside the sampled
blocks.  The math is the paper's divide-and-conquer tree (§3.2.1) for a
fixed partition.

On the card both steps run the ported kernels, as the reference's einsums
compute the same functions: the root's block masses
``alpha * h^T Z_b h + cnt_b`` go through ``ops.block_scores`` and the
within-block scores ``alpha * <w, h>^2 + 1`` through ``ops.leaf_scores``
over the gathered rows ``wq[blk]``.  Only degree-2 kernels take that route;
the quartic kernel keeps the plain ``of_dot``, a different function.

Two sampling modes:
  * per-example (``sample``, the paper's): each query draws its own
    negatives, batched over the T queries (the reference vmaps one query);
  * batch-shared (``sample_shared``): ONE negative set per batch, drawn from
    the batch-summed kernel  Q_i = sum_p K(h_p, w_i), which factors through
    the same Gram statistics by a Frobenius product, so its cost does not
    grow with T.  Its root and leaf scores are einsums (the reference's),
    no hand-written kernel.

Draws come from the caller's ``torch.Generator``, so they match the
reference in distribution, not bit for bit.  ``logq`` is always the exact
log-probability of the draw.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import hierarchy
from repro_torch.core.kernel_fns import SamplingKernel
from repro_torch.kernels import ops

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BlockStats:
    """Statistics for the two-level hierarchy.

    z:       (n_blocks, r, r) per-block Gram sums (fp32).
    cnt:     (n_blocks,) number of real (non-padding) classes per block.
    wq:      (n_blocks, block, r) sampling copy of the class embeddings
             (projected if proj was given; zero rows for padding).
    n_valid: 0-dim int32 tensor — number of real classes; ids at or after
             it carry exactly zero probability.
    """

    z: Tensor
    cnt: Tensor
    wq: Tensor
    n_valid: Tensor

    @property
    def n_blocks(self) -> int:
        return self.z.shape[0]

    @property
    def block_size(self) -> int:
        return self.wq.shape[1]

    @property
    def n_pad(self) -> int:
        return self.n_blocks * self.block_size

    def as_hierarchy(self) -> hierarchy.HierarchyStats:
        """The shared-core view: a depth-0 hierarchy (leaf level only)."""
        return hierarchy.HierarchyStats((self.z,), (self.cnt,),
                                        (hierarchy.leaf_ub(self.wq),),
                                        self.wq, self.n_valid, self.n_pad)


def _from_hierarchy(hs: hierarchy.HierarchyStats) -> BlockStats:
    return BlockStats(hs.levels_z[-1], hs.levels_cnt[-1], hs.wq, hs.n_valid)


def make_projection(gen: torch.Generator, d: int, r: int) -> Tensor:
    """JL random projection (r, d) on the generator's device, rows scaled so
    dots are preserved in expectation: P_ij ~ N(0, 1/r)."""
    return torch.randn((r, d), generator=gen, device=gen.device) / math.sqrt(r)


def build(w: Tensor, block_size: int, proj: Tensor | None = None,
          n_valid: Tensor | int | None = None) -> BlockStats:
    """(Re)build all block statistics: the leaf Grams through
    ``ops.zstats`` (``hierarchy.build``).  ``n_valid``: number of real
    classes (rows beyond it carry no mass)."""
    return _from_hierarchy(hierarchy.build(w, block_size, proj=proj,
                                           n_valid=n_valid, full_tree=False))


def update_rows(stats: BlockStats, ids: Tensor, w_new: Tensor,
                proj: Tensor | None = None) -> BlockStats:
    """Sparse refresh (paper Fig. 1b): add Delta(w w^T) to the touched
    blocks.  ids must be unique.  Cost O(k r^2)."""
    return _from_hierarchy(
        hierarchy.update_rows(stats.as_hierarchy(), ids, w_new, proj))


def _block_logits(kernel: SamplingKernel, stats: BlockStats,
                  hq: Tensor) -> Tensor:
    """log block masses log(alpha h^T Z_b h + cnt_b): hq (T, r) -> (T, N)."""
    if kernel.degree == 2:
        mass = ops.block_scores(hq, stats.z, stats.cnt, kernel.alpha)
    else:
        quad = torch.einsum("nij,ti,tj->tn", stats.z, hq, hq)
        mass = kernel.alpha * quad + stats.cnt
    return torch.log(torch.clamp(mass, min=1e-30))


def _within_block_logits(kernel: SamplingKernel, stats: BlockStats,
                         hq: Tensor, blk: Tensor) -> Tensor:
    """Exact kernel log-scores inside blocks: one query row of hq (G, r)
    per draw, blk (G,) -> (G, block).  The padding rows of ``wq`` are zero,
    so the kernel scores them alpha*0 + 1 = 1: the n_valid mask after it is
    what gives them zero mass."""
    rows = stats.wq[blk]  # (G, block, r)
    if kernel.degree == 2:
        scores = ops.leaf_scores(hq, rows, kernel.alpha)
    else:
        scores = kernel.of_dot(torch.einsum("gbr,gr->gb", rows, hq))
    bs = stats.block_size
    ids = blk[:, None] * bs + torch.arange(bs, device=blk.device)
    scores = torch.where(ids < stats.n_valid, scores, 0.0)
    return torch.where(scores > 0, torch.log(torch.clamp(scores, min=1e-30)),
                       -math.inf)


def sample(stats: BlockStats, kernel: SamplingKernel, h: Tensor, m: int,
           gen: torch.Generator, proj: Tensor | None = None
           ) -> tuple[Tensor, Tensor]:
    """Per-example sampling: m i.i.d. draws for each query of h: (T, d).

    Root: one block-mass table for all T queries (shared by their m draws).
    Leaf: exact scores inside each draw's block.
    Returns (ids (T, m) int64, logq (T, m) fp32), logq exact."""
    hq = hierarchy.project(h, proj)  # (T, r)
    t = hq.shape[0]
    log_p_blk = torch.log_softmax(_block_logits(kernel, stats, hq), dim=-1)
    blk = torch.multinomial(log_p_blk.exp(), m, replacement=True,
                            generator=gen)  # (T, m)
    flat = blk.reshape(-1)
    within_logits = _within_block_logits(
        kernel, stats, hq.repeat_interleave(m, dim=0), flat)
    log_p_within = torch.log_softmax(within_logits, dim=-1)  # (T*m, block)
    within = torch.multinomial(log_p_within.exp(), 1, generator=gen)
    logq = (torch.gather(log_p_blk, 1, blk)
            + torch.gather(log_p_within, 1, within).reshape(t, m))
    ids = flat * stats.block_size + within[:, 0]
    return ids.reshape(t, m), logq


def batch_context_gram(h: Tensor) -> tuple[Tensor, Tensor]:
    """Context Gram for batch-shared sampling: (sum_p h_p h_p^T, T as a
    0-dim fp32 tensor).  h: (T, d) raw (unprojected) hidden states."""
    h32 = h.float()
    return (torch.einsum("ti,tj->ij", h32, h32),
            torch.tensor(float(h.shape[0]), device=h.device))


def categorical_rows(gen: torch.Generator | None, logits: Tensor,
                     m: int) -> Tensor:
    """m categorical draws per row of ``logits`` (T, P) -> slots (T, m)
    int64, by the inverse CDF: ONE uniform per draw (the reference's
    rationale: ~T*m random numbers where a Gumbel draw takes ~T*m*P).

    Unlike the reference, which clips a uniform past the fp32 ``cdf[-1]``
    to the last slot whatever its mass, a draw never lands on a zero-mass
    slot: u is scaled by the row's ``cdf[-1]`` and a slot of zero mass
    gives way to the live slot before it."""
    probs = torch.softmax(logits.float(), dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    u = torch.rand((logits.shape[0], m), generator=gen, device=logits.device)
    idx = torch.searchsorted(cdf, (u * cdf[:, -1:]).contiguous(),
                             right=True)
    idx = torch.clamp(idx, max=logits.shape[-1] - 1)
    # the last live slot at or before each slot (a row has one at least)
    slots = torch.arange(logits.shape[-1], device=logits.device)
    live_at = torch.cummax(torch.where(probs > 0, slots, 0), dim=-1).values
    return torch.gather(live_at, 1, idx)


def shared_context(h: Tensor, proj: Tensor | None) -> Tensor:
    """The (projected) context Gram HH = sum_p hq_p hq_p^T: (r, r)."""
    return batch_context_gram(hierarchy.project(h, proj))[0]


def shared_block_log_probs(stats: BlockStats, kernel: SamplingKernel,
                           hh: Tensor, t: int) -> Tensor:
    """log p of every block under the batch-summed kernel:
    log_softmax(log(alpha * <Z_b, HH>_F + T * cnt_b)), (n_blocks,)."""
    mass = (kernel.alpha * torch.einsum("nij,ij->n", stats.z, hh)
            + t * stats.cnt)
    return torch.log_softmax(torch.log(torch.clamp(mass, min=1e-30)), dim=-1)


def shared_within_logits(stats: BlockStats, kernel: SamplingKernel,
                         hh: Tensor, t: int, blk: Tensor, *,
                         mega: bool) -> Tensor:
    """Exact batch-summed log-scores inside the blocks ``blk`` (m,):
    log(alpha * w^T HH w + T), padding at -inf -> (m, block).  ``mega``
    scores every block once (O(n r^2)) and gathers; otherwise the drawn
    blocks' rows are gathered and scored (O(m B r^2))."""
    if mega:
        quad = torch.einsum("nbr,rs,nbs->nb", stats.wq, hh, stats.wq)[blk]
    else:
        rows = stats.wq[blk]  # (m, block, r)
        quad = torch.sum((rows @ hh) * rows, dim=-1)
    scores = kernel.alpha * quad + t
    bs = stats.block_size
    ids = blk[:, None] * bs + torch.arange(bs, device=blk.device)
    scores = torch.where(ids < stats.n_valid, scores, 0.0)
    return torch.where(scores > 0, torch.log(torch.clamp(scores, min=1e-30)),
                       -math.inf)


def is_mega(stats: BlockStats, m: int) -> bool:
    """The mega-batch regime (tapas pools): far more draws than blocks, so
    every block is drawn repeatedly and is scored once."""
    return m >= 4 * stats.n_blocks


def sample_shared(stats: BlockStats, kernel: SamplingKernel, h: Tensor,
                  m: int, gen: torch.Generator, proj: Tensor | None = None
                  ) -> tuple[Tensor, Tensor]:
    """Batch-shared sampling from the batch-summed kernel.

    h: (T, d) all hidden states of the batch.  Draws ONE set of m negatives
    with q_i ∝ sum_p K(h_p, w_i), exactly, through the same statistics:

      block mass:  alpha * <Z_b, HH>_F + T * cnt_b        (one contraction)
      leaf score:  alpha * w^T HH w + T                    (rows @ HH)

    with HH the (projected) context Gram.  In the mega-batch regime
    (``is_mega``) every block is scored once and the within-block draw takes
    one uniform per draw (``categorical_rows``); otherwise one categorical
    per draw over its gathered block.  Returns (ids (m,) int64, logq (m,)),
    logq exact."""
    t = h.shape[0]
    hh = shared_context(h, proj)
    log_p_blk = shared_block_log_probs(stats, kernel, hh, t)
    blk = torch.multinomial(log_p_blk.exp(), m, replacement=True,
                            generator=gen)  # (m,)
    mega = is_mega(stats, m)
    log_p_within = torch.log_softmax(
        shared_within_logits(stats, kernel, hh, t, blk, mega=mega), dim=-1)
    if mega:
        within = categorical_rows(gen, log_p_within, 1)
    else:
        within = torch.multinomial(log_p_within.exp(), 1, generator=gen)
    logq = log_p_blk[blk] + torch.gather(log_p_within, 1, within)[:, 0]
    return blk * stats.block_size + within[:, 0], logq


def all_class_logq(stats: BlockStats, kernel: SamplingKernel, h: Tensor,
                   proj: Tensor | None = None, shared: bool = False
                   ) -> Tensor:
    """Exact log-probability of every class under the two-level sampler
    (test oracle, O(n r) / O(n r^2)).  h: (d,), or (T, d) with
    ``shared=True`` -> (n_pad,)."""
    if shared:
        hq = hierarchy.project(h, proj)
        hh = torch.einsum("ti,tj->ij", hq, hq)
        mass = (kernel.alpha * torch.einsum("nij,ij->n", stats.z, hh)
                + h.shape[0] * stats.cnt)
        quad = torch.einsum("nbr,rs,nbs->nb", stats.wq, hh, stats.wq)
        scores = kernel.alpha * quad + h.shape[0]
    else:
        hq = hierarchy.project(h[None], proj)[0]
        mass = (kernel.alpha * torch.einsum("nij,i,j->n", stats.z, hq, hq)
                + stats.cnt)
        scores = kernel.of_dot(torch.einsum("nbr,r->nb", stats.wq, hq))
    log_p_blk = torch.log_softmax(torch.log(torch.clamp(mass, min=1e-30)),
                                  dim=-1)
    bs = stats.block_size
    ids = (torch.arange(stats.n_blocks, device=hq.device)[:, None] * bs
           + torch.arange(bs, device=hq.device)[None, :])
    scores = torch.where(ids < stats.n_valid, scores, 0.0)
    logit = torch.where(scores > 0, torch.log(torch.clamp(scores, min=1e-30)),
                        -math.inf)
    log_within = torch.log_softmax(logit, dim=-1)
    return (log_p_blk[:, None] + log_within).reshape(-1)
