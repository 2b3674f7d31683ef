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
The reference's per-draw ``sample_sequential`` (its equivalence and
benchmark reference) is not ported (ROADMAP.md A3).
"""
from __future__ import annotations

import torch

from repro_torch.core import hierarchy
from repro_torch.core.hierarchy import HierarchyStats as TreeStats
from repro_torch.core.kernel_fns import SamplingKernel

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
