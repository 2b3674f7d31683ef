"""Hierarchical sampling statistics (``repro.core.hierarchy``, DESIGN.md
§2.1, §2.5-2.7).

A hierarchy of class sets whose per-node statistic is the Gram sum
``Z_C = sum_{j in C} w_j w_j^T`` plus a true-class count and the max
squared row norm ``ub(C)``, so that the quadratic-kernel mass of a node is
``alpha * h^T Z_C h + |C|``; the serving index (``serve/retrieval.py``)
prunes with the same statistics.  The leaf Grams go through ``ops.zstats``
(the CUDA kernel on the card), which computes the same function as the
reference's einsum.

``descend`` is the level-synchronous batched descent of the paper's tree
(§3.2): all (T, m) draws advance one level per step; dense levels score
every node through ``ops.block_scores``, the leaf step scores the sampled
leaves through ``ops.leaf_scores``.  The feature half (``FeatureStats``,
``build_features``, ``descend_features``) is the same tree over positive
random-feature sums for the exp kernel; its leaf level is built by
``ops.rff_features`` and its leaf step scores through ``ops.leaf_dots``.

Draws come from the caller's ``torch.Generator``: per level one uniform per
draw against the right child's probability (a Bernoulli), then one
categorical per draw inside its leaf.  They match the reference in
distribution, not bit for bit.  ``logq`` is the exact log-probability of
the draw; each level adds ``log(mass of the child taken) - log(mass of
both)``, which keeps its digits where the reference's ``log(1 - p_r)``
cancels (p_r near 1).  A zero-mass child (a padding-only subtree) is never
taken: a uniform in [0, 1) is never below p = 0.

``update_rows`` / ``update_feature_rows`` are the paper's Fig. 1b sparse
refresh: after the rows of ``ids`` change, each level along the touched
leaf-to-root paths gets the rows' delta (a scatter-add) instead of a
rebuild.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.kernel_fns import (
    SamplingKernel,
    gram_set_mass,
    rff_log_phi,
    rff_logshift_bound,
    rff_phi,
)
from repro_torch.kernels import ops
from repro_torch.utils.misc import log2_int, next_pow2

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class HierarchyStats:
    """Per-level Gram statistics + the (possibly projected) sampling table.

    levels_z:   tuple over levels root..leaf of (nodes_l, r, r) fp32 Gram
                sums; level l of a full binary tree holds 2^l nodes, and the
                two-level form holds only the leaf level.
    levels_cnt: tuple over levels of (nodes_l,) fp32 true (non-padding)
                counts |C|.
    levels_ub:  tuple over levels of (nodes_l,) fp32 max squared row norms
                ``max_{j in C} ||w_j||^2``.
    wq:         (num_leaves, leaf_size, r) fp32 copy of the class embeddings
                (projected if a projection was given; zero rows for padding
                and for rows at/after ``n_valid``).
    n_valid:    0-dim int32 tensor on ``wq``'s device — number of real
                classes.
    n:          row-count bound (the table size at build time).
    """

    levels_z: tuple[Tensor, ...]
    levels_cnt: tuple[Tensor, ...]
    levels_ub: tuple[Tensor, ...]
    wq: Tensor
    n_valid: Tensor
    n: int

    @property
    def depth(self) -> int:
        return len(self.levels_z) - 1

    @property
    def num_leaves(self) -> int:
        return self.wq.shape[0]

    @property
    def leaf_size(self) -> int:
        return self.wq.shape[1]

    @property
    def n_pad(self) -> int:
        return self.num_leaves * self.leaf_size


def _n_valid_tensor(n_valid, device: torch.device) -> Tensor:
    return torch.as_tensor(n_valid, dtype=torch.int32, device=device)


def project(w: Tensor, proj: Tensor | None) -> Tensor:
    """fp32 copy of ``w``, optionally moved to the rank-r sampling space."""
    w32 = w.float()
    if proj is None:
        return w32
    return w32 @ proj.float().T


def leaf_counts(n_valid: Tensor, num_leaves: int, leaf_size: int) -> Tensor:
    """True (non-padding) class count of each leaf block.

    n_valid: 0-dim int tensor -> (num_leaves,) fp32 counts."""
    starts = torch.arange(num_leaves, dtype=torch.float32,
                          device=n_valid.device) * leaf_size
    return torch.clamp(n_valid.float() - starts, 0.0, float(leaf_size))


def leaf_ub(wq: Tensor) -> Tensor:
    """Max squared row norm of each leaf block: wq (L, B, r) -> (L,) fp32."""
    return torch.amax(torch.sum(wq * wq, dim=-1), dim=-1)


def ub_levels_from_wq(wq: Tensor, depth: int) -> tuple[Tensor, ...]:
    """Rebuild the per-level max-norm statistic bottom-up from ``wq``."""
    levels = [leaf_ub(wq)]
    for _ in range(depth):
        child = levels[0]
        levels.insert(0, torch.maximum(child[0::2], child[1::2]))
    return tuple(levels)


def build(w: Tensor, leaf_size: int, *, proj: Tensor | None = None,
          n_valid: Tensor | int | None = None,
          full_tree: bool = True) -> HierarchyStats:
    """Build the hierarchy bottom-up: leaf Gram blocks, then pairwise sums.

    w: (n, d) class embeddings.  ``full_tree=True`` rounds the leaf count to
    a power of two and builds every binary level up to the root;
    ``full_tree=False`` keeps only the leaf level.  ``n_valid``: number of
    real classes (rows beyond it carry no mass).  Level tuples are ordered
    root..leaf."""
    n_rows, _ = w.shape
    if n_valid is None:
        n_valid = n_rows
    n_valid = _n_valid_tensor(n_valid, w.device)
    wq = project(w, proj)
    r = wq.shape[-1]
    if full_tree:
        leaf_size = next_pow2(leaf_size)
        num_leaves = next_pow2(max(1, -(-n_rows // leaf_size)))
    else:
        num_leaves = -(-n_rows // leaf_size)
    pad = num_leaves * leaf_size - n_rows
    wq = torch.nn.functional.pad(wq, (0, 0, 0, pad))
    # Zero any rows at/after n_valid (pads must carry no mass).
    row_ok = torch.arange(num_leaves * leaf_size, device=w.device) < n_valid
    wq = torch.where(row_ok[:, None], wq, 0.0)
    wq = wq.reshape(num_leaves, leaf_size, r)

    z = ops.zstats(wq)  # (num_leaves, r, r)
    cnt = leaf_counts(n_valid, num_leaves, leaf_size)

    levels_z = [z]
    levels_cnt = [cnt]
    levels_ub = [leaf_ub(wq)]
    if full_tree:
        while levels_z[0].shape[0] > 1:
            child_z = levels_z[0]
            child_c = levels_cnt[0]
            child_u = levels_ub[0]
            levels_z.insert(0, child_z[0::2] + child_z[1::2])
            levels_cnt.insert(0, child_c[0::2] + child_c[1::2])
            levels_ub.insert(0, torch.maximum(child_u[0::2], child_u[1::2]))
    return HierarchyStats(tuple(levels_z), tuple(levels_cnt),
                          tuple(levels_ub), wq, n_valid, n_rows)


def update_rows(stats: HierarchyStats, ids: Tensor, w_new: Tensor,
                proj: Tensor | None = None) -> HierarchyStats:
    """Paper Fig. 1b: after the embeddings of ``ids`` change to ``w_new``,
    add ``Delta(w w^T)`` to every level along each leaf-to-root path.

    ids: (k,) class indices; w_new: (k, d).  Cost O(k * depth * r^2) for
    the Gram sums; the max-norm bound cannot be decremented sparsely, so
    touched leaves recompute theirs from ``wq`` and the max propagates up
    the same paths.  Duplicate ids are NOT allowed (which old row a
    duplicate reads is undefined)."""
    wq_new = project(w_new, proj)
    ids = ids.long()
    leaf_of = torch.div(ids, stats.leaf_size, rounding_mode="floor")
    off = ids % stats.leaf_size
    wq_old = stats.wq[leaf_of, off]
    delta = (torch.einsum("ki,kj->kij", wq_new, wq_new)
             - torch.einsum("ki,kj->kij", wq_old, wq_old))
    wq = stats.wq.index_put((leaf_of, off), wq_new)

    depth = stats.depth
    new_z = tuple(z.index_add(0, leaf_of >> (depth - lvl), delta)
                  for lvl, z in enumerate(stats.levels_z))
    new_ub = list(stats.levels_ub)
    new_ub[depth] = new_ub[depth].index_put((leaf_of,), leaf_ub(wq[leaf_of]))
    for lvl in range(depth - 1, -1, -1):
        node_of = leaf_of >> (depth - lvl)
        child = new_ub[lvl + 1]
        new_ub[lvl] = new_ub[lvl].index_put(
            (node_of,), torch.maximum(child[2 * node_of],
                                      child[2 * node_of + 1]))
    return HierarchyStats(new_z, stats.levels_cnt, tuple(new_ub), wq,
                          stats.n_valid, stats.n)


# --- flat heap packing (DESIGN.md §2.5) --------------------------------------


def heap_rows(num_leaves: int) -> int:
    """Rows of the packed heap: 2^(d+1)-1 nodes padded to an even 2*L."""
    return 2 * num_leaves


def pack_levels(levels) -> Tensor:
    """Heap-pack a root..leaf tuple of per-level tensors into one tensor.

    Level l occupies rows [2^l - 1, 2^(l+1) - 1); one zero padding row
    rounds the total to an even 2L — the layout ``RetrievalIndex`` carries."""
    first = levels[0]
    pad = torch.zeros((1, *first.shape[1:]), dtype=first.dtype,
                      device=first.device)
    return torch.cat(list(levels) + [pad], dim=0)


def unpack_levels(heap: Tensor, depth: int) -> tuple[Tensor, ...]:
    """Inverse of ``pack_levels``: contiguous row slices back to
    root..leaf."""
    out, off = [], 0
    for lvl in range(depth + 1):
        size = 1 << lvl
        out.append(heap[off:off + size])
        off += size
    return tuple(out)


def to_heap(stats: HierarchyStats) -> tuple[Tensor, Tensor]:
    """Pack levels root..leaf into flat (2L, r, r) / (2L,) tensors.  The
    max-norm bound is not packed — ``from_heap`` rebuilds it from ``wq``."""
    return pack_levels(stats.levels_z), pack_levels(stats.levels_cnt)


def from_heap(z_heap: Tensor, cnt_heap: Tensor, wq: Tensor, n_valid,
              n: int | None = None) -> HierarchyStats:
    """Inverse of ``to_heap``: row slices back into per-level tuples, with
    the max-norm bound rebuilt from ``wq``."""
    num_leaves = wq.shape[0]
    depth = log2_int(num_leaves)
    if z_heap.shape[0] != heap_rows(num_leaves):
        raise ValueError(f"heap of {z_heap.shape[0]} rows does not fit "
                         f"{num_leaves} leaves")
    if n is None:
        n = num_leaves * wq.shape[1]
    return HierarchyStats(unpack_levels(z_heap, depth),
                          unpack_levels(cnt_heap, depth),
                          ub_levels_from_wq(wq, depth), wq,
                          _n_valid_tensor(n_valid, wq.device), n)


# --- level-synchronous batched descent (DESIGN.md §2.6) ----------------------


def _mass_table(kernel: SamplingKernel, z: Tensor, cnt: Tensor,
                hq: Tensor) -> Tensor:
    """Kernel mass of EVERY node at one level for every query: (T, nodes),
    through ``ops.block_scores``."""
    return ops.block_scores(hq, z, cnt, alpha=kernel.alpha)


def _gathered_mass(kernel: SamplingKernel, z: Tensor, cnt: Tensor,
                   hq: Tensor, nodes: Tensor) -> Tensor:
    """Kernel mass of per-draw gathered nodes: hq (T, r), nodes (T, m)."""
    quad = torch.einsum("tmij,ti,tj->tm", z[nodes], hq, hq)
    return kernel.alpha * quad + cnt[nodes]


def _level_step(mass_l: Tensor, mass_r: Tensor, idx: Tensor, logq: Tensor,
                gen: torch.Generator) -> tuple[Tensor, Tensor]:
    """One Bernoulli branch per draw: go right with p_r = m_r / (m_l + m_r).
    Returns the new node indices and the updated log-probabilities."""
    total = torch.clamp(mass_l + mass_r, min=1e-30)
    u = torch.rand(idx.shape, generator=gen, device=idx.device)
    go_right = u < mass_r / total
    idx = 2 * idx + go_right
    logq = logq + torch.log(torch.where(go_right, mass_r, mass_l)) \
        - torch.log(total)
    return idx, logq


def _leaf_draw(logits: Tensor, idx: Tensor, logq: Tensor, leaf_size: int,
               gen: torch.Generator) -> tuple[Tensor, Tensor]:
    """One categorical per draw inside its leaf: logits (T, m, B) ->
    (ids (T, m) int64, logq (T, m))."""
    t, m, b = logits.shape
    log_p = torch.log_softmax(logits, dim=-1).reshape(t * m, b)
    within = torch.multinomial(log_p.exp(), 1, generator=gen)  # (T*m, 1)
    log_within = torch.gather(log_p, 1, within).reshape(t, m)
    ids = idx * leaf_size + within.reshape(t, m)
    return ids, logq + log_within


def leaf_logits(stats: HierarchyStats, kernel: SamplingKernel, hq: Tensor,
                leaf_idx: Tensor) -> Tensor:
    """Exact within-leaf kernel log-scores, padding masked to -inf (the Fig.
    1c leaf step), through ``ops.leaf_scores``.

    hq: (T, r) projected queries; leaf_idx: (T, m) sampled leaf indices
    -> (T, m, leaf_size)."""
    t, m = leaf_idx.shape
    b = stats.leaf_size
    rows = stats.wq[leaf_idx].reshape(t * m, b, -1)  # (T*m, B, r)
    flat_h = hq.repeat_interleave(m, dim=0)  # row t repeated m times
    scores = ops.leaf_scores(flat_h, rows, alpha=kernel.alpha
                             ).reshape(t, m, b)
    ids = leaf_idx[..., None] * b + torch.arange(b, device=hq.device)
    scores = torch.where(ids < stats.n_valid, scores, 0.0)
    return torch.where(scores > 0, torch.log(torch.clamp(scores, min=1e-30)),
                       -math.inf)


def descend(stats: HierarchyStats, kernel: SamplingKernel, hq: Tensor,
            m: int, gen: torch.Generator, *,
            dense_cap: int | None = None) -> tuple[Tensor, Tensor]:
    """Level-synchronous batched descent: m draws per query of hq (T, r),
    depth + 1 batched steps in all.

    Levels with at most ``dense_cap`` nodes compute the full (T, nodes)
    mass table (``ops.block_scores``) and gather the two child masses per
    draw; deeper levels gather per-draw child statistics (the paper's
    per-draw O(r^2) bound).  ``dense_cap=0`` forces the gathered form
    everywhere.  Both forms consume the generator alike, so one seed gives
    the same draws either way wherever the masses agree.

    Returns ids (T, m) int64 and logq (T, m) fp32, exact."""
    if kernel.degree != 2:
        raise ValueError("hierarchy statistics require a degree-2 kernel")
    t = hq.shape[0]
    if dense_cap is None:
        # Dense tables cost T*nodes*r^2 contiguous flops, the gathered form
        # ~2*T*m*r^2 scattered ones: dense until a level is several times
        # wider than the draw count.
        dense_cap = max(256, 4 * m)
    hq = hq.float()
    idx = torch.zeros((t, m), dtype=torch.int64, device=hq.device)
    logq = torch.zeros((t, m), dtype=torch.float32, device=hq.device)
    for lvl in range(1, stats.depth + 1):
        z, cnt = stats.levels_z[lvl], stats.levels_cnt[lvl]
        left, right = 2 * idx, 2 * idx + 1
        if z.shape[0] <= dense_cap:
            table = _mass_table(kernel, z, cnt, hq)
            mass_l = torch.gather(table, 1, left)
            mass_r = torch.gather(table, 1, right)
        else:
            mass_l = _gathered_mass(kernel, z, cnt, hq, left)
            mass_r = _gathered_mass(kernel, z, cnt, hq, right)
        idx, logq = _level_step(mass_l, mass_r, idx, logq, gen)
    logits = leaf_logits(stats, kernel, hq, idx)
    return _leaf_draw(logits, idx, logq, stats.leaf_size, gen)


def _all_class_from_levels(level_log_mass, within_logits: Tensor,
                           n: int) -> Tensor:
    """Telescoping node probabilities + within-leaf conditional -> (n,)
    logq.  level_log_mass: root..leaf list of (nodes_l,) log node masses;
    within_logits: (num_leaves, leaf_size) log scores (-inf pads)."""
    log_node = None
    for lvl, lm in enumerate(level_log_mass):
        if lvl == 0:
            log_node = torch.zeros((lm.shape[0],), device=lm.device)
        else:
            parent = log_node.repeat_interleave(2)
            sibling = torch.logaddexp(lm[0::2], lm[1::2]).repeat_interleave(2)
            log_node = parent + lm - sibling
    # Entirely-dead leaves would NaN through log_softmax; their entries are
    # exactly zero-probability.
    log_within = torch.where(torch.isneginf(within_logits), -math.inf,
                             torch.log_softmax(within_logits, dim=-1))
    return (log_node[:, None] + log_within).reshape(-1)[:n]


def all_class_logq(stats: HierarchyStats, kernel: SamplingKernel,
                   hq: Tensor) -> Tensor:
    """Exact log-probability the hierarchy assigns to EVERY class (test
    oracle, O(n r^2)).  hq: (r,) one projected query -> (n,)."""
    hq = hq.float()
    level_lm = [torch.log(torch.clamp(gram_set_mass(
                    kernel, stats.levels_z[lvl], stats.levels_cnt[lvl], hq),
                    min=1e-30))
                for lvl in range(stats.depth + 1)]
    scores = kernel.of_dot(torch.einsum("lbr,r->lb", stats.wq, hq))
    ids = (torch.arange(stats.num_leaves, device=hq.device)[:, None]
           * stats.leaf_size
           + torch.arange(stats.leaf_size, device=hq.device)[None, :])
    scores = torch.where(ids < stats.n_valid, scores, 0.0)
    logit = torch.where(scores > 0, torch.log(torch.clamp(scores, min=1e-30)),
                        -math.inf)
    return _all_class_from_levels(level_lm, logit, stats.n)


# --- feature-sum hierarchy (positive RFF / exp kernel; DESIGN.md §2.7) -------
#
# For the exp kernel the summary statistic is literally eq. 8's
# z(C) = sum_{j in C} phi(w_j): (nodes, D) per level, and a node's mass is
# <phi(h), z(C)> ~ sum_{j in C} exp(<h, w_j>/tau).  Inside a sampled leaf
# the classes are scored with the EXACT exp kernel (log score <h, w>/tau),
# so the reported logq is exact under the distribution sampled from; the
# random features only shape q at the node level.


@dataclasses.dataclass(frozen=True)
class FeatureStats:
    """Per-level positive-RFF feature sums + the raw sampling table.

    levels_f:  tuple over levels root..leaf of (nodes_l, D) fp32
               non-negative feature sums; level l holds 2^l nodes.
    wq:        (num_leaves, leaf_size, d) fp32 raw class embeddings (zero
               rows for padding and rows at/after ``n_valid``).
    logshift:  0-dim fp32 log-domain shift baked into every feature of
               ``levels_f`` (common to all nodes, cancels in sampling).
    n_valid:   0-dim int32 — number of real classes.
    n:         row-count bound (the table size at build time).
    """

    levels_f: tuple[Tensor, ...]
    wq: Tensor
    logshift: Tensor
    n_valid: Tensor
    n: int

    @property
    def depth(self) -> int:
        return len(self.levels_f) - 1

    @property
    def num_leaves(self) -> int:
        return self.wq.shape[0]

    @property
    def leaf_size(self) -> int:
        return self.wq.shape[1]

    @property
    def n_pad(self) -> int:
        return self.num_leaves * self.leaf_size

    @property
    def feature_dim(self) -> int:
        return self.levels_f[0].shape[-1]


def build_features(w: Tensor, leaf_size: int, omega: Tensor, tau: float, *,
                   n_valid: Tensor | int | None = None) -> FeatureStats:
    """Build the RFF hierarchy bottom-up: the leaf feature sums through
    ``ops.rff_features`` (the (n, D) feature matrix is never written on the
    card), then pairwise parents.  w: (n, d); omega: (D, d) fixed Gaussian
    directions (drawn once, carried like a projection)."""
    n_rows, d = w.shape
    if n_valid is None:
        n_valid = n_rows
    n_valid = _n_valid_tensor(n_valid, w.device)
    leaf_size = next_pow2(leaf_size)
    num_leaves = next_pow2(max(1, -(-n_rows // leaf_size)))
    pad = num_leaves * leaf_size - n_rows
    wq = torch.nn.functional.pad(w.float(), (0, 0, 0, pad))
    row_ok = torch.arange(num_leaves * leaf_size, device=w.device) < n_valid
    wq = torch.where(row_ok[:, None], wq, 0.0)
    # Zero rows still have phi = exp(-logshift) > 0, so padding needs an
    # explicit mask (the Gram build gets this for free from w w^T = 0).
    mask = row_ok.float().reshape(num_leaves, leaf_size)
    logshift = rff_logshift_bound(wq, omega, tau)
    wq = wq.reshape(num_leaves, leaf_size, d)
    levels_f = [ops.rff_features(wq, omega.float(), mask, logshift, tau=tau)]
    while levels_f[0].shape[0] > 1:
        child = levels_f[0]
        levels_f.insert(0, child[0::2] + child[1::2])
    return FeatureStats(tuple(levels_f), wq, logshift, n_valid, n_rows)


def update_feature_rows(stats: FeatureStats, ids: Tensor, w_new: Tensor,
                        omega: Tensor, tau: float) -> FeatureStats:
    """Paper Fig. 1b for the feature hierarchy: add ``Delta phi(w)`` along
    each leaf-to-root path after the embeddings of ``ids`` change to
    ``w_new``.

    ids: (k,) class indices; w_new: (k, d).  Cost O(k * D * (d + depth)).
    New features reuse the stored ``logshift`` (a grown row may exceed
    exp(0) = 1, far below fp32 overflow).  Duplicate ids are NOT allowed."""
    ids = ids.long()
    leaf_of = torch.div(ids, stats.leaf_size, rounding_mode="floor")
    off = ids % stats.leaf_size
    w32 = w_new.float()
    delta = (rff_phi(w32, omega, tau, stats.logshift)
             - rff_phi(stats.wq[leaf_of, off], omega, tau, stats.logshift))
    wq = stats.wq.index_put((leaf_of, off), w32)
    depth = stats.depth
    new_f = tuple(f.index_add(0, leaf_of >> (depth - lvl), delta)
                  for lvl, f in enumerate(stats.levels_f))
    return FeatureStats(new_f, wq, stats.logshift, stats.n_valid, stats.n)


def count_levels(n_valid: Tensor, num_leaves: int, leaf_size: int,
                 depth: int) -> tuple[Tensor, ...]:
    """Per-level true class counts root..leaf (pure function of n_valid)."""
    levels = [leaf_counts(n_valid, num_leaves, leaf_size)]
    for _ in range(depth):
        child = levels[0]
        levels.insert(0, child[0::2] + child[1::2])
    return tuple(levels)


def to_feature_heap(stats: FeatureStats) -> tuple[Tensor, Tensor]:
    """Pack the feature levels into the flat heap carriage: (f_heap (2L, D),
    aux_heap (2L,)).  The aux heap holds the per-node true counts, and
    ``logshift`` in its single padding row (the last)."""
    aux = pack_levels(count_levels(stats.n_valid, stats.num_leaves,
                                   stats.leaf_size, stats.depth))
    aux[-1] = stats.logshift
    return pack_levels(stats.levels_f), aux


def from_feature_heap(f_heap: Tensor, aux_heap: Tensor, wq: Tensor, n_valid,
                      n: int | None = None) -> FeatureStats:
    """Inverse of ``to_feature_heap``: row slices back into level tuples;
    ``logshift`` from the aux heap's last row."""
    num_leaves = wq.shape[0]
    depth = log2_int(num_leaves)
    if f_heap.shape[0] != heap_rows(num_leaves):
        raise ValueError(f"heap of {f_heap.shape[0]} rows does not fit "
                         f"{num_leaves} leaves")
    if n is None:
        n = num_leaves * wq.shape[1]
    return FeatureStats(unpack_levels(f_heap, depth), wq, aux_heap[-1],
                        _n_valid_tensor(n_valid, wq.device), n)


def _query_features(h: Tensor, omega: Tensor, tau: float) -> Tensor:
    """Per-query log-domain-normalized features: (T, d) -> (T, D).  The
    per-query max shift cancels in the query's branch probabilities."""
    lphi = rff_log_phi(h, omega, tau)
    return torch.exp(lphi - torch.amax(lphi, dim=-1, keepdim=True))


def leaf_logits_exp(stats: FeatureStats, hq: Tensor, leaf_idx: Tensor,
                    tau: float) -> Tensor:
    """EXACT within-leaf exp-kernel log-scores log K = <h, w>/tau, through
    ``ops.leaf_dots`` (the leaf kernel's raw-dot mode).  hq: (T, d) raw
    queries; leaf_idx: (T, m) -> (T, m, leaf_size), padding at -inf."""
    t, m = leaf_idx.shape
    b = stats.leaf_size
    rows = stats.wq[leaf_idx].reshape(t * m, b, -1)
    dots = ops.leaf_dots(hq.repeat_interleave(m, dim=0), rows
                         ).reshape(t, m, b)
    ids = leaf_idx[..., None] * b + torch.arange(b, device=hq.device)
    return torch.where(ids < stats.n_valid, dots / tau, -math.inf)


def descend_features(stats: FeatureStats, omega: Tensor, tau: float,
                     h: Tensor, m: int, gen: torch.Generator, *,
                     dense_cap: int | None = None) -> tuple[Tensor, Tensor]:
    """Level-synchronous batched descent over RFF masses: m draws per raw
    query of h (T, d).  Each dense level is one (T, D) x (D, nodes)
    product; deeper levels gather per-draw child feature sums; the leaf
    step uses the exact exp kernel.  Returns ids (T, m) int64 and logq
    (T, m), exact under the hierarchy's distribution."""
    h = h.float()
    t = h.shape[0]
    if dense_cap is None:
        dense_cap = max(256, 4 * m)
    phi_h = _query_features(h, omega, tau)  # (T, D)
    idx = torch.zeros((t, m), dtype=torch.int64, device=h.device)
    logq = torch.zeros((t, m), dtype=torch.float32, device=h.device)
    for lvl in range(1, stats.depth + 1):
        f = stats.levels_f[lvl]  # (nodes, D)
        left, right = 2 * idx, 2 * idx + 1
        if f.shape[0] <= dense_cap:
            table = phi_h @ f.T  # (T, nodes)
            mass_l = torch.gather(table, 1, left)
            mass_r = torch.gather(table, 1, right)
        else:
            mass_l = torch.einsum("tmk,tk->tm", f[left], phi_h)
            mass_r = torch.einsum("tmk,tk->tm", f[right], phi_h)
        idx, logq = _level_step(mass_l, mass_r, idx, logq, gen)
    logits = leaf_logits_exp(stats, h, idx, tau)
    return _leaf_draw(logits, idx, logq, stats.leaf_size, gen)


def all_class_logq_features(stats: FeatureStats, omega: Tensor, tau: float,
                            h: Tensor) -> Tensor:
    """Exact log-probability the RFF hierarchy assigns to EVERY class (test
    oracle, O(n D)): node probabilities from the RFF masses, the
    within-leaf conditional from the exact exp kernel.  h: (d,) -> (n,)."""
    h = h.float()
    phi_h = _query_features(h[None], omega, tau)[0]  # (D,)
    level_lm = [torch.log(torch.clamp(stats.levels_f[lvl] @ phi_h,
                                      min=1e-30))
                for lvl in range(stats.depth + 1)]
    logit = torch.einsum("lbr,r->lb", stats.wq, h) / tau
    ids = (torch.arange(stats.num_leaves, device=h.device)[:, None]
           * stats.leaf_size
           + torch.arange(stats.leaf_size, device=h.device)[None, :])
    logit = torch.where(ids < stats.n_valid, logit, -math.inf)
    return _all_class_from_levels(level_lm, logit, stats.n)
