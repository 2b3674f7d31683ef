"""Quantized inverted multi-index (MIDX) sampling core
(``repro.core.midx``, DESIGN.md §2.9).

The third hierarchy backend beside Gram trees and RFF feature heaps: the
class table is split into P balanced posting lists (``pc_bisect_perm``),
each list's centroid is product-quantized into a PAIR of codewords (a
coarse codebook c1 and a residual codebook c2), and sampling runs in two
stages:

  stage 1   every list's quantized kernel mass
                mass_j = cnt_j * K(<h, c1[a1_j] + c2[a2_j]>)
            through ``ops.midx_list_masses``; draw a list per draw.
  stage 2   the drawn list's members scored with the EXACT kernel through
            ``ops.midx_member_scores``; draw within.

The reported logq is the exact composed probability
``log softmax(list masses)[j] + log softmax(within scores)[i]`` under the
distribution actually sampled from.  Every valid class lives in a list with
cnt > 0 and has kernel score >= 1, so q > 0 on every valid class.

Stage 1 draws with ``torch.multinomial`` on the normalized masses, which
never returns a zero-probability category: an EMPTY list (cnt = 0, all of
its member logits -inf) is never drawn.  (The reference's inverse-CDF draw
can land past an fp32 cumulative sum that ends short of 1 and clip onto
the last list, which is empty when n is not a multiple of the list size;
ROADMAP.md C.)  Draws come from the caller's ``torch.Generator``.

Layout: lists are balanced (all P = 2^depth lists hold L rows; padding is
a contiguous suffix, so cnt_j = clip(n_valid - j L, 0, L)); the codebooks
come from a deterministic strided-init Lloyd's k-means (no generator); and
``perm`` maps packed position -> original row id.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.kernel_fns import SamplingKernel
from repro_torch.kernels import ops
from repro_torch.utils.misc import log2_int, next_pow2

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MidxStats:
    """Statistics of the two-level quantized index.

    c1:      (K1, d) fp32 coarse codebook (k-means of the list centroids).
    c2:      (K2, d) fp32 residual codebook; one zero row with codebooks=1.
    codes:   (P, 2) int32 codeword pair (a1, a2) of each posting list.
    cnt:     (P,) fp32 valid rows per list.
    perm:    (P*L,) int32 packed position -> original row id.
    wq:      (P, L, d) fp32 member rows in packed order (padding zeroed).
    n_valid: 0-dim int32 — number of real classes.
    """

    c1: Tensor
    c2: Tensor
    codes: Tensor
    cnt: Tensor
    perm: Tensor
    wq: Tensor
    n_valid: Tensor

    @property
    def num_lists(self) -> int:
        return self.wq.shape[0]

    @property
    def list_size(self) -> int:
        return self.wq.shape[1]

    @property
    def n_pad(self) -> int:
        return self.num_lists * self.list_size


def list_dims(n: int, d: int, list_size: int | None = None
              ) -> tuple[int, int]:
    """ONE formula for (num_lists P, list size L), shared by ``build`` and
    ``MIDXSampler.state_shapes``."""
    leaf = next_pow2(max(2, min(n, list_size if list_size else d)))
    return next_pow2(max(1, -(-n // leaf))), leaf


def pc_bisect_perm(w: Tensor, n_valid: Tensor | int, depth: int,
                   iters: int = 8) -> Tensor:
    """Balanced PC-bisection co-clustering permutation.

    w: (n_pad, d) with n_pad = 2^depth * leaf_size.  Level by level, each
    node's rows are sorted by their projection onto the node's top principal
    direction (a few power iterations on the uncentered second moment) and
    split in half.  Rows at/after ``n_valid`` sort with key +inf, so padding
    stays a contiguous suffix; the sort is STABLE, as ``jnp.argsort`` is, so
    the padding suffix keeps its order.  Returns (n_pad,) int32: packed
    position -> original row."""
    n_pad, d = w.shape
    w32 = w.float()
    perm = torch.arange(n_pad, dtype=torch.int64, device=w.device)
    for lvl in range(depth):
        nb = 1 << lvl
        bs = n_pad >> lvl
        blocks = w32[perm].reshape(nb, bs, d)
        v = torch.sum(blocks, dim=1)
        v = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-9)
        for _ in range(iters):
            u = torch.einsum("nbd,nd->nb", blocks, v)
            v = torch.einsum("nbd,nb->nd", blocks, u)
            v = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-9)
        key = torch.einsum("nbd,nd->nb", blocks, v)
        key = torch.where(perm.reshape(nb, bs) < n_valid, key, torch.inf)
        order = torch.sort(key, dim=1, stable=True).indices
        perm = torch.gather(perm.reshape(nb, bs), 1, order).reshape(-1)
    return perm.to(torch.int32)


def kmeans(x: Tensor, k: int, iters: int = 8,
           mask: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Deterministic fixed-iteration Lloyd's k-means.

    x: (n, d) points; mask: (n,) bool — points excluded from centroid
    updates (their assignment is arbitrary).  Init is strided over the
    (post-bisection, spatially sorted) point order; empty clusters keep
    their centroid; ties go to the lowest centroid index (``argmin``, as in
    the reference).  Returns (centroids (k, d) fp32, assignments (n,)
    int32)."""
    n, _ = x.shape
    x32 = x.float()
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=x.device)
    c = x32[(torch.arange(k, device=x.device) * n) // k]
    x2 = torch.sum(x32 * x32, dim=1, keepdim=True)
    ks = torch.arange(k, device=x.device)

    def assign(c_):
        d2 = x2 - 2.0 * x32 @ c_.T + torch.sum(c_ * c_, dim=1)[None, :]
        return torch.argmin(d2, dim=1)

    for _ in range(iters):
        a = assign(c)
        hot = ((a[:, None] == ks[None, :]) & mask[:, None]).float()
        csum = hot.T @ x32
        ccnt = torch.sum(hot, dim=0)
        c = torch.where(ccnt[:, None] > 0,
                        csum / torch.clamp(ccnt, min=1.0)[:, None], c)
    return c, assign(c).to(torch.int32)


def build(w: Tensor, *, codewords: int, codebooks: int = 2,
          list_size: int | None = None, n_valid: Tensor | int | None = None,
          kmeans_iters: int = 8) -> MidxStats:
    """(Re)build the full index from a class table — the refresh step: one
    bisection pass, then two small k-means over the P list centroids."""
    n_rows, d = w.shape
    if n_valid is None:
        n_valid = n_rows
    n_valid = torch.as_tensor(n_valid, dtype=torch.int32, device=w.device)
    num_lists, leaf = list_dims(n_rows, d, list_size)
    n_pad = num_lists * leaf
    w_pad = torch.nn.functional.pad(w.float(), (0, 0, 0, n_pad - n_rows))
    row_ok = torch.arange(n_pad, device=w.device) < n_valid
    w_pad = torch.where(row_ok[:, None], w_pad, 0.0)
    perm = pc_bisect_perm(w_pad, n_valid, log2_int(num_lists))
    rows = w_pad[perm.long()].reshape(num_lists, leaf, d)
    # Balanced lists + contiguous padding suffix -> closed-form counts.
    cnt = torch.clamp(n_valid - torch.arange(num_lists, device=w.device)
                      * leaf, 0, leaf).float()
    live = cnt > 0
    mu = torch.sum(rows, dim=1) / torch.clamp(cnt, min=1.0)[:, None]
    c1, a1 = kmeans(mu, codewords, kmeans_iters, live)
    if codebooks == 2:
        c2, a2 = kmeans(mu - c1[a1.long()], codewords, kmeans_iters, live)
    else:
        c2 = torch.zeros((1, d), dtype=torch.float32, device=w.device)
        a2 = torch.zeros((num_lists,), dtype=torch.int32, device=w.device)
    codes = torch.stack([a1, a2], dim=1).to(torch.int32)
    return MidxStats(c1=c1, c2=c2, codes=codes, cnt=cnt, perm=perm, wq=rows,
                     n_valid=n_valid)


# --- scoring -----------------------------------------------------------------


def quantized_dots(stats: MidxStats, h: Tensor) -> Tensor:
    """Stage-1 quantized logits t[j] = <h, c1[a1_j] + c2[a2_j]> for a batch
    of queries, through two (T, K) codebook products and a gather: (T, P)."""
    h32 = h.float()
    hc1 = h32 @ stats.c1.T
    hc2 = h32 @ stats.c2.T
    return (hc1[:, stats.codes[:, 0].long()]
            + hc2[:, stats.codes[:, 1].long()])


def _log_mass(mass: Tensor) -> Tensor:
    return torch.where(mass > 0, torch.log(torch.clamp(mass, min=1e-30)),
                       -math.inf)


def _require_quadratic(kernel: SamplingKernel) -> None:
    if kernel.degree != 2:
        raise ValueError("the midx kernels score the quadratic kernel only, "
                         f"not {kernel.name}")


def list_log_masses(stats: MidxStats, kernel: SamplingKernel, h: Tensor
                    ) -> Tensor:
    """log of the stage-1 masses for every list: (T, P); empty lists -inf.
    Scored by ``ops.midx_list_masses`` (the CUDA kernel on the card)."""
    _require_quadratic(kernel)
    mass = ops.midx_list_masses(h.float(), stats.c1, stats.c2, stats.codes,
                                stats.cnt, alpha=kernel.alpha)
    return _log_mass(mass)


def member_log_scores(stats: MidxStats, kernel: SamplingKernel, h: Tensor,
                      lists: Tensor) -> Tensor:
    """Stage-2 EXACT within-list kernel log-scores: h (T, d), lists (T, m)
    -> (T, m, L), padding slots at -inf.  Scored by
    ``ops.midx_member_scores`` over the gathered (T*m, L, d) rows."""
    _require_quadratic(kernel)
    t, m = lists.shape
    leaf = stats.list_size
    rows = stats.wq[lists]                       # (T, m, L, d)
    scores = ops.midx_member_scores(
        h.float().repeat_interleave(m, dim=0), rows.reshape(t * m, leaf, -1),
        alpha=kernel.alpha).reshape(t, m, leaf)
    pos = lists[..., None] * leaf + torch.arange(leaf, device=h.device)
    scores = torch.where(pos < stats.n_valid, scores, 0.0)
    return _log_mass(scores)


# --- sampling ----------------------------------------------------------------


def sample_batch(stats: MidxStats, kernel: SamplingKernel, h: Tensor, m: int,
                 gen: torch.Generator) -> tuple[Tensor, Tensor]:
    """Batched two-stage draw: h (T, d) -> (ids (T, m) int64 ORIGINAL class
    ids, logq (T, m) exact composed log-probabilities)."""
    t = h.shape[0]
    log_p_list = torch.log_softmax(list_log_masses(stats, kernel, h), dim=-1)
    lists = torch.multinomial(log_p_list.exp(), m, replacement=True,
                              generator=gen)                      # (T, m)
    log_p_within = torch.log_softmax(
        member_log_scores(stats, kernel, h, lists), dim=-1
    ).reshape(t * m, -1)
    within = torch.multinomial(log_p_within.exp(), 1, generator=gen)
    logq = (torch.gather(log_p_list, 1, lists)
            + torch.gather(log_p_within, 1, within).reshape(t, m))
    packed = lists * stats.list_size + within.reshape(t, m)
    return stats.perm[packed].long(), logq


def sample(stats: MidxStats, kernel: SamplingKernel, h: Tensor, m: int,
           gen: torch.Generator) -> tuple[Tensor, Tensor]:
    """Single-query form: h (d,) -> (ids (m,), logq (m,))."""
    ids, logq = sample_batch(stats, kernel, h[None, :], m, gen)
    return ids[0], logq[0]


def all_class_logq(stats: MidxStats, kernel: SamplingKernel,
                   h: Tensor) -> Tensor:
    """Exact log-probability of EVERY original class id under the two-stage
    sampler (test oracle and ``midx-oracle``, O(n d) a query), from the
    plain quantized dots.  h: (d,) -> (n_pad,), or (T, d) -> (T, n_pad),
    indexed by ORIGINAL row id; padding rows are -inf."""
    h32 = h.float().reshape(-1, h.shape[-1])                      # (T, d)
    mass = stats.cnt * kernel.of_dot(quantized_dots(stats, h32))
    log_p_list = torch.log_softmax(_log_mass(mass), dim=-1)       # (T, P)
    scores = kernel.of_dot(torch.einsum("pld,td->tpl", stats.wq, h32))
    pos = (torch.arange(stats.num_lists, device=h.device)[:, None]
           * stats.list_size
           + torch.arange(stats.list_size, device=h.device)[None, :])
    scores = torch.where(pos < stats.n_valid, scores, 0.0)
    logit = _log_mass(scores)
    # Empty lists are all -inf rows; mask BEFORE log_softmax can NaN them.
    live = stats.cnt[:, None] > 0
    log_within = torch.where(
        live, torch.log_softmax(torch.where(live, logit, 0.0), dim=-1),
        -math.inf)
    log_within = torch.where(logit == -math.inf, -math.inf, log_within)
    out = torch.full((h32.shape[0], stats.n_pad), -math.inf,
                     device=h.device)
    out[:, stats.perm.long()] = (log_p_list[:, :, None]
                                 + log_within).reshape(h32.shape[0], -1)
    return out.reshape(*h.shape[:-1], stats.n_pad)
