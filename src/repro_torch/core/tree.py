"""The paper's divide-and-conquer sampling tree (§3.2, Fig. 1) —
``repro.core.tree``.

A balanced binary tree over the classes with Gram statistics per node
(``core/hierarchy.py``), a root-to-leaf descent that takes each child with
probability ``<phi(h), z(C')> / <phi(h), z(C)>`` (eq. 9), and leaves scored
exactly in the original space (Fig. 1c).  Sampling is the level-synchronous
batched descent (``hierarchy.descend``): the dense levels through
``ops.block_scores``, the leaf step through ``ops.leaf_scores``.

An optional fixed projection ``P: (r, d)`` moves sampling into a rank-r
space; ``proj=None`` is the paper-exact sampler.  Draws come from the
caller's ``torch.Generator``.

``update_path`` is the Fig. 1b sparse refresh along the touched paths.
``sample_sequential`` keeps the paper's per-draw descent (one Bernoulli a
level, then the leaf) as the equivalence and benchmark reference of the
batched descent; the two consume a generator differently, so they agree in
distribution.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import hierarchy
from repro_torch.core.hierarchy import HierarchyStats as TreeStats
from repro_torch.core.kernel_fns import SamplingKernel, gram_set_mass

Tensor = torch.Tensor

_project = hierarchy.project


def default_leaf_size(n: int, r: int) -> int:
    """Paper Fig. 1c: stop splitting at |C| = O(D/d); D = r^2 here."""
    return max(2, min(n, r))


def build(w: Tensor, kernel: SamplingKernel, leaf_size: int | None = None,
          proj: Tensor | None = None,
          n_valid: Tensor | int | None = None) -> TreeStats:
    """Build the tree bottom-up: leaf Gram blocks (``ops.zstats``), then
    pairwise sums.  w: (n, d); ``n_valid`` marks trailing padding rows."""
    if kernel.degree != 2:
        raise ValueError("tree statistics require the quadratic kernel")
    if leaf_size is None:
        r = proj.shape[0] if proj is not None else w.shape[1]
        leaf_size = default_leaf_size(w.shape[0], r)
    return hierarchy.build(w, leaf_size, proj=proj, n_valid=n_valid,
                           full_tree=True)


def sample_batch(stats: TreeStats, kernel: SamplingKernel, h: Tensor, m: int,
                 gen: torch.Generator, proj: Tensor | None = None, *,
                 dense_cap: int | None = None) -> tuple[Tensor, Tensor]:
    """m i.i.d. draws per query of h: (T, d).  Returns ids (T, m) int64 and
    logq (T, m), the exact log sampling probabilities."""
    return hierarchy.descend(stats, kernel, _project(h, proj), m, gen,
                             dense_cap=dense_cap)


def sample(stats: TreeStats, kernel: SamplingKernel, h: Tensor, m: int,
           gen: torch.Generator, proj: Tensor | None = None, *,
           dense_cap: int | None = None) -> tuple[Tensor, Tensor]:
    """m i.i.d. draws (with replacement) for one query h: (d,) -> (ids (m,),
    logq (m,))."""
    ids, logq = sample_batch(stats, kernel, h[None], m, gen, proj,
                             dense_cap=dense_cap)
    return ids[0], logq[0]


# --- sequential reference (the paper's per-draw descent) ---------------------


def _leaf_scores_one(stats: TreeStats, kernel: SamplingKernel, hq: Tensor,
                     leaf_idx: int) -> Tensor:
    """Exact kernel scores of one leaf block, padding masked to 0."""
    rows = stats.wq[leaf_idx]  # (leaf_size, r)
    scores = kernel.of_dot(rows @ hq)  # (leaf_size,)
    ids = leaf_idx * stats.leaf_size + torch.arange(stats.leaf_size,
                                                    device=hq.device)
    return torch.where(ids < stats.n_valid, scores, 0.0)


def _descend_one(stats: TreeStats, kernel: SamplingKernel, hq: Tensor,
                 gen: torch.Generator) -> tuple[int, Tensor]:
    """Sample a single class: root-to-leaf descent + exact leaf step.

    Returns (class_id, log_q) with log_q the exact log-probability of the
    draw under the tree's distribution (the telescoping product of eq. 9).
    """
    idx = 0
    logq = torch.zeros((), device=hq.device)
    for lvl in range(1, stats.depth + 1):
        z, cnt = stats.levels_z[lvl], stats.levels_cnt[lvl]
        left, right = 2 * idx, 2 * idx + 1
        mass_l = gram_set_mass(kernel, z[left], cnt[left], hq)
        mass_r = gram_set_mass(kernel, z[right], cnt[right], hq)
        # Numerical floor: padding-only subtrees have exactly zero mass.
        p_r = mass_r / torch.clamp(mass_l + mass_r, min=1e-30)
        go_right = bool(torch.rand((), generator=gen, device=hq.device)
                        < p_r)
        idx = right if go_right else left
        logq = logq + torch.log(p_r if go_right else 1.0 - p_r)
    scores = _leaf_scores_one(stats, kernel, hq, idx)
    logits = torch.where(scores > 0, torch.log(torch.clamp(scores,
                                                           min=1e-30)),
                         -math.inf)
    log_p = torch.log_softmax(logits, dim=-1)
    within = int(torch.multinomial(log_p.exp(), 1, generator=gen))
    return idx * stats.leaf_size + within, logq + log_p[within]


def sample_sequential(stats: TreeStats, kernel: SamplingKernel, h: Tensor,
                      m: int, gen: torch.Generator,
                      proj: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """The original per-draw, per-query descent (equivalence + benchmark
    reference): m independent root-to-leaf walks for one query h: (d,).
    Returns ids (m,) int64 and logq (m,)."""
    hq = _project(h[None], proj)[0]
    draws = [_descend_one(stats, kernel, hq, gen) for _ in range(m)]
    ids = torch.tensor([i for i, _ in draws], dtype=torch.int64,
                       device=hq.device)
    return ids, torch.stack([lq for _, lq in draws])


def all_class_logq(stats: TreeStats, kernel: SamplingKernel, h: Tensor,
                   proj: Tensor | None = None) -> Tensor:
    """Exact log-probability the tree assigns to EVERY class (test oracle,
    O(n r^2)).  h: (d,) -> (n,)."""
    hq = _project(h[None], proj)[0]
    return hierarchy.all_class_logq(stats, kernel, hq)


def update_path(stats: TreeStats, kernel: SamplingKernel, ids: Tensor,
                w_new: Tensor, proj: Tensor | None = None) -> TreeStats:
    """Paper Fig. 1b: after the embeddings of ``ids`` change to ``w_new``,
    update the statistics along each leaf-to-root path with Delta phi(w).
    ids: (k,) unique class indices; w_new: (k, d).  Cost
    O(k * depth * r^2)."""
    if kernel.degree != 2:
        raise ValueError("tree statistics require the quadratic kernel")
    return hierarchy.update_rows(stats, ids, w_new, proj)
