"""Hierarchy-backed top-k MIPS retrieval for serving — unsharded port of
``repro.serve.retrieval`` (DESIGN.md §5).

For any node (class set) C the index's statistics bound the best logit
inside it,

    max_{j in C} <h, w_j>  <=  min( sqrt(h^T Z_C h),              [gram]
                                    ||h|| * sqrt(max ||w_j||^2),  [norm]
                                    <h, mu_C> + ||h|| * rad_C )   [ball]

and wide levels use the rank-s spectral compression of [gram],
``h^T Z_C h <= sum_{i<s} lam_i <h, v_i>^2 + lam_res ||h||^2``  [spec].

  * ``beam_descent`` — batched level-synchronous beam search: all T queries
                       advance one level per step and keep the top-``beam``
                       children by upper bound.  With ``gram_cap`` the exact
                       gram bound's dense levels go through the
                       ``block_scores`` CUDA kernel.
  * ``leaf_topk``    — exact scoring of the surviving leaves' classes
                       (raw dots through the ``leaf_scores`` CUDA kernel in
                       dot mode) and a flat top-k over them.
  * ``RetrievalIndex`` — the heap-packed statistics plus the clustering
                       permutation.

``use_kernels=None`` means "the tensors are on CUDA", as the reference's
means "the backend is TPU".  Every top-k breaks ties by the lowest index
(``utils.misc.top_k``), as ``lax.top_k`` does.

On a ``(data, model)`` mesh (``sharding/rules.py``) the index is
vocab-sharded: ``build_index`` builds one local hierarchy on each rank of
the model group from its head rows, and the rank keeps only that shard
(``shard_index``), as the reference's P('model') arrays keep one shard a
device.  ``decode_topk`` runs the beam over this rank's subtree (the top
log2(tp) levels of the global hierarchy ARE the shard index) and merges
the shards' k candidates with one (T, tp k) all-gather and a top-k.  A
sharded index decodes only on its mesh; ``convert.index_to_jax`` gathers
the shards into the reference's shard-after-shard layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import distributed, hierarchy
from repro_torch.core.hierarchy import HierarchyStats
from repro_torch.core.midx import pc_bisect_perm
from repro_torch.kernels import ops
from repro_torch.sharding import rules
from repro_torch.utils.misc import log2_int, next_pow2, resolve_device, top_k

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RetrievalIndex:
    """Packed serving index; with ``tp > 1`` the tensors hold ONE shard's
    heap: shard ``shard_index`` of ``tp``, built from head rows
    [shard_index v_shard, (shard_index + 1) v_shard) (the sizes below are
    the shard's).

    z:       (2L, r, r) fp32 heap-packed per-level Gram sums.
    cnt:     (2L,) fp32 heap-packed per-node true-class counts.
    wq:      (L, leaf, r) fp32 leaf table — an exact (unprojected) copy of
             the class embeddings, so leaf dots are the logits.
    mu:      (2L, r) fp32 heap-packed per-node centroids.
    rad:     (2L,) fp32 heap-packed covering radii ``max_j ||w_j - mu_C||``.
    evecs:   (2L, s, r) fp32 heap-packed top-s eigenvectors of each Z_C.
    evals:   (2L, s + 1) fp32 top-s eigenvalues plus the residual cap.
    perm:    (L * leaf,) int32 — packed position -> original row id.
    n:       true class count (rows at/after it are padding).
    tp:      vocab-parallel degree the heap was packed for.
    v_shard: embedding rows per shard (>= n when tp == 1).
    shard_index: the shard these tensors hold (0 when tp == 1).
    """

    z: Tensor
    cnt: Tensor
    wq: Tensor
    mu: Tensor
    rad: Tensor
    evecs: Tensor
    evals: Tensor
    perm: Tensor
    n: int
    tp: int
    v_shard: int
    shard_index: int = 0

    TENSORS = ("z", "cnt", "wq", "mu", "rad", "evecs", "evals", "perm")

    @property
    def num_leaves_shard(self) -> int:
        return self.wq.shape[0]

    @property
    def leaf_size(self) -> int:
        return self.wq.shape[1]


def default_leaf_size(n_rows: int, d: int) -> int:
    """Serving leaf size: wide enough to amortize the gather, power of two."""
    return next_pow2(max(2, min(n_rows, max(d, 32))))


def ball_stats(w_pad: Tensor, n_valid: Tensor | int, depth: int
               ) -> tuple[tuple[Tensor, ...], tuple[Tensor, ...]]:
    """Per-level ball-bound statistics from the PACKED row table.

    w_pad: (n_pad, r) rows in leaf order, padding zeroed.  Returns
    (levels_mu root..leaf of (nodes, r), levels_rad of (nodes,)): the exact
    centroid of each node's valid rows and the exact covering radius."""
    n_pad, r = w_pad.shape
    valid = torch.arange(n_pad, device=w_pad.device) < n_valid
    mus, rads = [], []
    for lvl in range(depth + 1):
        nodes = 1 << lvl
        grp = n_pad // nodes
        wv = w_pad.reshape(nodes, grp, r)
        vv = valid.reshape(nodes, grp)
        cnt = torch.sum(vv, dim=1)
        mu = torch.sum(wv, dim=1) / torch.clamp(cnt, min=1)[:, None]
        d2 = torch.sum(torch.square(wv - mu[:, None, :]), dim=-1)
        rads.append(torch.sqrt(torch.amax(torch.where(vv, d2, 0.0), dim=1)))
        mus.append(mu)
    return tuple(mus), tuple(rads)


def spectral_stats(levels_z, s: int = 4
                   ) -> tuple[tuple[Tensor, ...], tuple[Tensor, ...]]:
    """Rank-s spectral compression of every node's Gram sum.

    Returns (levels_evecs of (nodes, s, r), levels_evals of (nodes, s+1))
    with evals[..., s] the residual cap (0 when s >= r).  One batched
    ``eigh`` per level (ascending, as the reference's) — build-time only.
    Eigenvectors are defined up to sign and rotation within degenerate
    eigenspaces; the bound values they give are not."""
    r = levels_z[0].shape[-1]
    s = min(s, r)
    evecs_lvls, evals_lvls = [], []
    for z in levels_z:
        vals, vecs = torch.linalg.eigh(z)  # ascending
        top_vals = vals.flip(-1)[..., :s]
        top_vecs = vecs.flip(-1)[..., :s].transpose(-1, -2)  # (n, s, r)
        if s == r:
            res = torch.zeros(vals.shape[:-1], dtype=vals.dtype,
                              device=vals.device)
        else:
            res = vals[..., r - s - 1]
        evecs_lvls.append(top_vecs.contiguous())
        evals_lvls.append(torch.cat([top_vals, res[..., None]], dim=-1))
    return tuple(evecs_lvls), tuple(evals_lvls)


def _build_local(w_local: Tensor, leaf: int, n_valid: int, cluster: bool):
    """The unsharded build: pad, cluster, build, pack.

    w_local: (v_l, d) embedding rows -> heap tensors + wq + perm."""
    v_l, d = w_local.shape
    leaf = next_pow2(leaf)
    num_leaves = next_pow2(max(1, -(-v_l // leaf)))
    n_pad = num_leaves * leaf
    w_pad = torch.nn.functional.pad(w_local.float(), (0, 0, 0, n_pad - v_l))
    # Zero rows at/after n_valid now: divisibility padding must not pollute
    # the clustering directions or the ball centroids/radii.
    row_ok = torch.arange(n_pad, device=w_pad.device) < n_valid
    w_pad = torch.where(row_ok[:, None], w_pad, 0.0)
    if cluster:
        perm = pc_bisect_perm(w_pad, n_valid, log2_int(num_leaves))
        w_pad = w_pad[perm.long()]
    else:
        perm = torch.arange(n_pad, dtype=torch.int32, device=w_pad.device)
    stats = hierarchy.build(w_pad, leaf, n_valid=n_valid, full_tree=True)
    z, cnt = hierarchy.to_heap(stats)
    mus, rads = ball_stats(w_pad, n_valid, stats.depth)
    evecs, evals = spectral_stats(stats.levels_z)
    pack = hierarchy.pack_levels
    return (z, cnt, stats.wq, pack(mus), pack(rads), pack(evecs),
            pack(evals), perm)


@torch.no_grad()
def build_index(w, ctx=None, *, leaf_size: int | None = None,
                vocab_size: int | None = None, cluster: bool = True,
                device: str | torch.device | None = None) -> RetrievalIndex:
    """Build the serving index from a class-embedding table.

    w: (n, d) head table (numpy or tensor), UNPROJECTED; with a mesh ctx
    this rank's (v_l, d) vocab shard (a mesh train state's head).  A numpy
    table is moved to ``device`` (the card unless ``device="cpu"``; no
    device and no CUDA raises); a tensor stays on its device unless
    ``device`` is given.
    vocab_size: true class count when ``w`` carries divisibility padding.
    cluster: PC-bisection co-clustering of the rows (recommended; on a
    mesh each shard clusters its own rows)."""
    if isinstance(w, np.ndarray):
        w = torch.from_numpy(w).to(resolve_device(device))
    elif device is not None:
        w = w.to(device)
    n_rows, d = w.shape
    if not rules.on_mesh(ctx):
        n = vocab_size if vocab_size is not None else n_rows
        leaf = leaf_size or default_leaf_size(n_rows, d)
        z, cnt, wq, mu, rad, evc, evl, perm = _build_local(w, leaf, n,
                                                           cluster)
        return RetrievalIndex(z, cnt, wq, mu, rad, evc, evl, perm, n=n,
                              tp=1, v_shard=n_rows)
    n = vocab_size if vocab_size is not None else n_rows * ctx.tp
    leaf = leaf_size or default_leaf_size(n_rows, d)
    j = ctx.model_index
    return RetrievalIndex(
        *_build_local(w, leaf, rules.local_n_valid(n, n_rows, j), cluster),
        n=n, tp=ctx.tp, v_shard=n_rows, shard_index=j)


def index_stats(index: RetrievalIndex, shard: int | None = None,
                n_valid: Tensor | int | None = None) -> HierarchyStats:
    """Rehydrate the heap tensors into ``HierarchyStats``: the index's own
    shard (``shard``, when given, must name it)."""
    if shard is not None and shard != index.shard_index:
        raise ValueError(f"the index holds shard {index.shard_index}, "
                         f"not {shard}")
    if n_valid is None:
        n_valid = rules.local_n_valid(index.n, index.v_shard,
                                      index.shard_index)
    return hierarchy.from_heap(index.z, index.cnt, index.wq, n_valid)


# --- batched beam descent ----------------------------------------------------


def _ub_dense(stats: HierarchyStats, lvl: int, hq: Tensor, hnorm: Tensor,
              ball, spec, with_gram: bool, use_kernels: bool) -> Tensor:
    """Upper-bound table for EVERY node at one level: (T, nodes_l)."""
    z, cnt, ub2 = (stats.levels_z[lvl], stats.levels_cnt[lvl],
                   stats.levels_ub[lvl])
    bound = hnorm[:, None] * torch.sqrt(ub2)[None, :]
    if with_gram:
        if use_kernels:
            quad = ops.block_scores(hq, z, torch.zeros_like(cnt), alpha=1.0)
        else:
            quad = torch.einsum("nij,ti,tj->tn", z, hq, hq)
        bound = torch.minimum(bound, torch.sqrt(torch.clamp(quad, min=0.0)))
    elif spec is not None:
        evc, evl = spec[0][lvl], spec[1][lvl]  # (N, s, r), (N, s+1)
        proj = torch.einsum("nsr,tr->tns", evc, hq)
        quad_ub = (torch.einsum("ns,tns->tn", evl[:, :-1], proj * proj)
                   + evl[None, :, -1] * (hnorm * hnorm)[:, None])
        bound = torch.minimum(bound,
                              torch.sqrt(torch.clamp(quad_ub, min=0.0)))
    if ball is not None:
        mu, rad = ball[0][lvl], ball[1][lvl]
        bound = torch.minimum(bound,
                              hq @ mu.T + hnorm[:, None] * rad[None, :])
    return torch.where(cnt[None, :] > 0, bound, -torch.inf)


def _ub_gathered(stats: HierarchyStats, lvl: int, hq: Tensor, hnorm: Tensor,
                 ball, spec, with_gram: bool, nodes: Tensor) -> Tensor:
    """Upper bounds of per-query gathered nodes: hq (T, r), nodes (T, C)."""
    z, cnt, ub2 = (stats.levels_z[lvl], stats.levels_cnt[lvl],
                   stats.levels_ub[lvl])
    bound = hnorm[:, None] * torch.sqrt(ub2[nodes])
    if with_gram:
        quad = torch.einsum("tcij,ti,tj->tc", z[nodes], hq, hq)
        bound = torch.minimum(bound, torch.sqrt(torch.clamp(quad, min=0.0)))
    elif spec is not None:
        evc, evl = spec[0][lvl], spec[1][lvl]
        proj = torch.einsum("tcsr,tr->tcs", evc[nodes], hq)
        evl_n = evl[nodes]
        quad_ub = (torch.einsum("tcs,tcs->tc", evl_n[..., :-1], proj * proj)
                   + evl_n[..., -1] * (hnorm * hnorm)[:, None])
        bound = torch.minimum(bound,
                              torch.sqrt(torch.clamp(quad_ub, min=0.0)))
    if ball is not None:
        mu, rad = ball[0][lvl], ball[1][lvl]
        bound = torch.minimum(
            bound, torch.einsum("tcr,tr->tc", mu[nodes], hq)
            + hnorm[:, None] * rad[nodes])
    return torch.where(cnt[nodes] > 0, bound, -torch.inf)


def beam_descent(stats: HierarchyStats, h: Tensor, beam: int, *,
                 ball=None, spec=None, use_kernels: bool | None = None,
                 dense_cap: int | None = None,
                 gram_cap: int | None = None) -> Tensor:
    """Level-synchronous batched beam search down the Gram hierarchy.

    h: (T, r) queries.  Per level: expand every beam node into its two
    children and keep the top-``beam`` candidates per query by upper bound.
    Levels with at most ``dense_cap`` nodes evaluate the full (T, nodes)
    bound table; deeper levels gather per-candidate statistics.
    ``gram_cap`` (default 0) replaces the spectral bound with the exact gram
    bound on levels with at most that many nodes; with ``use_kernels`` its
    dense tables go through the ``block_scores`` kernel.

    Returns (T, min(beam, num_leaves)) int64 leaf indices, best bound
    first.  ``beam >= num_leaves`` keeps every node — exhaustive, exact."""
    if use_kernels is None:
        use_kernels = h.is_cuda
    if dense_cap is None:
        dense_cap = max(64, 2 * beam)
    if gram_cap is None:
        gram_cap = 0
    hq = h.float()
    hnorm = torch.sqrt(torch.sum(hq * hq, dim=-1))
    t = hq.shape[0]
    idx = torch.zeros((t, 1), dtype=torch.int64, device=hq.device)
    for lvl in range(1, stats.depth + 1):
        nodes_l = stats.levels_z[lvl].shape[0]
        with_gram = nodes_l <= gram_cap
        cand = torch.cat([2 * idx, 2 * idx + 1], dim=1)
        if nodes_l <= dense_cap:
            table = _ub_dense(stats, lvl, hq, hnorm, ball, spec, with_gram,
                              use_kernels)
            ub = torch.gather(table, 1, cand)
        else:
            ub = _ub_gathered(stats, lvl, hq, hnorm, ball, spec, with_gram,
                              cand)
        keep = min(beam, cand.shape[1])
        _, sel = top_k(ub, keep)
        idx = torch.gather(cand, 1, sel)
    return idx


def leaf_topk(stats: HierarchyStats, h: Tensor, leaves: Tensor, k: int, *,
              use_kernels: bool | None = None) -> tuple[Tensor, Tensor]:
    """Exact top-k over the classes of the surviving leaves.

    h: (T, r); leaves: (T, B) leaf indices -> ids (T, k) int32 class
    positions and logits (T, k) fp32 exact dots, sorted descending.
    Padding rows (position >= n_valid) score -inf.  With ``use_kernels``
    the B * leaf_size gathered rows are scored by the ``leaf_scores`` kernel
    in dot mode."""
    if use_kernels is None:
        use_kernels = h.is_cuda
    hq = h.float()
    t, b = leaves.shape
    leaf = stats.leaf_size
    if k > b * leaf:
        raise ValueError(f"k={k} needs beam*leaf_size >= k, got {b}*{leaf}")
    rows = stats.wq[leaves]  # (T, B, leaf, r)
    if use_kernels:
        flat_rows = rows.reshape(t * b, leaf, -1)
        flat_h = torch.repeat_interleave(hq, b, dim=0)
        dots = ops.leaf_dots(flat_h, flat_rows).reshape(t, b, leaf)
    else:
        dots = torch.einsum("tblr,tr->tbl", rows, hq)
    ids = leaves[..., None] * leaf + torch.arange(leaf, device=hq.device)
    dots = torch.where(ids < stats.n_valid, dots, -torch.inf)
    logits, sel = top_k(dots.reshape(t, b * leaf), k)
    ids = torch.gather(ids.reshape(t, b * leaf), 1, sel)
    return ids.to(torch.int32), logits


def topk(stats: HierarchyStats, h: Tensor, k: int, beam: int | None = None,
         *, ball=None, spec=None, use_kernels: bool | None = None,
         dense_cap: int | None = None,
         gram_cap: int | None = None) -> tuple[Tensor, Tensor]:
    """Single-shard top-k MIPS: beam descent + exact leaf scoring.

    h: (T, r) -> (ids (T, k) int32 PACKED positions, logits (T, k) fp32),
    best first.  ``beam=None`` (or >= num_leaves) is exhaustive and exact."""
    if beam is None:
        beam = stats.num_leaves
    leaves = beam_descent(stats, h, beam, ball=ball, spec=spec,
                          use_kernels=use_kernels, dense_cap=dense_cap,
                          gram_cap=gram_cap)
    return leaf_topk(stats, h, leaves, k, use_kernels=use_kernels)


def _shard_topk(index: RetrievalIndex, h: Tensor, k: int,
                beam: int | None, **knobs) -> tuple[Tensor, Tensor]:
    """The index's own shard's beam retrieval: (GLOBAL ids (T, k) int32,
    logits)."""
    depth = log2_int(index.num_leaves_shard)
    stats = index_stats(index)
    ball = (hierarchy.unpack_levels(index.mu, depth),
            hierarchy.unpack_levels(index.rad, depth))
    spec = (hierarchy.unpack_levels(index.evecs, depth),
            hierarchy.unpack_levels(index.evals, depth))
    pos, logits = topk(stats, h, k, beam, ball=ball, spec=spec, **knobs)
    # packed -> original local -> global
    return (index.perm[pos.long()] + index.shard_index * index.v_shard,
            logits)


@torch.no_grad()
def decode_topk(index: RetrievalIndex, h: Tensor, k: int,
                beam: int | None = None, ctx=None, *,
                use_kernels: bool | None = None,
                dense_cap: int | None = None,
                gram_cap: int | None = None) -> tuple[Tensor, Tensor]:
    """Top-k ids + logits over the full vocab through the packed index.

    h: (T, d) hidden states on the index's device -> (ids (T, k) int32
    class ids, logits (T, k) fp32 exact dots), sorted descending.

    On a mesh this rank retrieves from its own shard's subtree and the
    model group merges every shard's k candidates (one all-gather of (T,
    tp k)).  A sharded index without its mesh raises."""
    knobs = dict(use_kernels=use_kernels, dense_cap=dense_cap,
                 gram_cap=gram_cap)
    if not rules.on_mesh(ctx):
        if index.tp != 1:
            raise ValueError(f"an index sharded over tp={index.tp} decodes "
                             f"on its mesh (ctx)")
        return _shard_topk(index, h, k, beam, **knobs)
    if (index.tp, index.shard_index) != (ctx.tp, ctx.model_index):
        raise ValueError(f"shard {index.shard_index} of an index packed for "
                         f"tp={index.tp} on model position "
                         f"{ctx.model_index} of tp={ctx.tp}")
    ids, logits = _shard_topk(index, h, k, beam, **knobs)
    group = ctx.model_group
    all_ids = distributed.all_gather_tiled(ids, group, dim=1)
    all_logits = distributed.all_gather_tiled(logits, group, dim=1)
    logits, sel = top_k(all_logits, k)
    return torch.gather(all_ids, 1, sel), logits


# --- measurement -------------------------------------------------------------


@torch.no_grad()
def dense_topk(w: Tensor, h: Tensor, k: int, n_valid: int | None = None,
               ctx=None) -> tuple[Tensor, Tensor]:
    """O(n d) reference: exact top-k by dense logits (a plain fp32 matmul).
    On a mesh ``w`` is this rank's (v_l, d) vocab shard and ``n_valid`` the
    whole vocabulary: the shard's padding rows are masked and the shards'
    candidates merged over the model group
    (``distributed.sharded_logits_topk``)."""
    if rules.on_mesh(ctx):
        v_l = w.shape[0]
        n_l = rules.local_n_valid(n_valid if n_valid is not None
                                  else v_l * ctx.tp, v_l, ctx.model_index)
        bias = torch.where(torch.arange(v_l, device=w.device) < n_l,
                           0.0, -torch.inf)
        return distributed.sharded_logits_topk(
            w, h, k, group=ctx.model_group, bias_local=bias)
    logits = h.float() @ w.float().T
    if n_valid is not None and n_valid < w.shape[0]:
        logits = torch.where(
            torch.arange(w.shape[0], device=logits.device) < n_valid,
            logits, -torch.inf)
    vals, ids = top_k(logits, k)
    return ids.to(torch.int32), vals


def recall_at_k(index: RetrievalIndex, w: Tensor, h: Tensor, k: int,
                beam: int, ctx=None) -> float:
    """Measured recall knob: |retrieved ∩ true top-k| / k, averaged over T
    (on a mesh ``w`` is this rank's head shard)."""
    ids, _ = decode_topk(index, h, k, beam, ctx)
    true_ids, _ = dense_topk(w, h, k, n_valid=index.n, ctx=ctx)
    hits = (ids[:, :, None] == true_ids[:, None, :]).any(dim=1)
    return float(torch.mean(torch.sum(hits, dim=-1) / k))


def scored_classes(index: RetrievalIndex, beam: int | None) -> int:
    """Classes exactly scored per query — the beam path's 'work' metric."""
    b = index.num_leaves_shard if beam is None else min(
        beam, index.num_leaves_shard)
    return index.tp * b * index.leaf_size
