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

``sample`` is batched over the T queries (the reference vmaps one query);
draws come from the caller's ``torch.Generator`` (block, then within
block), so they match the reference in distribution, not bit for bit.
``logq`` is always the exact log-probability of the draw.

``update_rows``, ``batch_context_gram``, ``categorical_rows`` and
``sample_shared`` arrive with the batch-shared slice.
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
