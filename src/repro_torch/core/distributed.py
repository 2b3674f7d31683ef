"""Vocab-sharded kernel sampling + sampled-softmax loss over
``torch.distributed`` (``repro.core.distributed``, DESIGN.md §2.5).

The class-embedding table (the head) is sharded over the model group of a
``(data, model)`` mesh (``sharding/rules.py``): shard ``j`` holds rows
``[j v_l, (j + 1) v_l)``.  The paper's tree maps onto the group: the top
log2(tp) levels of the divide & conquer hierarchy ARE the shard index.
The *stratified* form: every shard draws m/tp negatives from its local
kernel distribution, and the expected-occurrence correction uses the exact
global probabilities q~_i = q_local(i) / tp, so E[count_i] = m q~_i and
eq. 2 applies verbatim.  Stratification removes all cross-shard sampling
traffic.

Two-stage (tapas) samplers: every shard draws pool/tp candidates from its
LOCAL base distribution, the pool's ids, inclusion log-probabilities and
embedding rows are all-gathered over the model group (the one place a
(pool, d) tensor crosses shards; its backward sums the cotangent over the
group and keeps the owning shard's rows), every shard re-scores the
replicated pool, and each draws m/tp slots from the SAME composed global
q, so the eq. 2 correction is ``logq + log m`` with no stratification
factor.

Every function runs on each rank of the model group ``group`` (a
``ProcessGroup``; None = one shard, no collectives) with its own
``w_local`` and the group's common ``h`` and ``labels``, and apart from
the tapas pool gather communicates only through psum / pmax / pmin of
(T,)-vectors, never gathered logits.  The collectives are the autograd
Functions below:

  psum        forward an all-reduce (sum); backward passes the (replicated)
              cotangent to each rank's local part unchanged.
  pmax, pmin  all-reduces of values that carry no gradient.
  all_gather_tiled  forward the ranks' parts concatenated in rank order;
              backward its transpose, ``reduce_scatter_tiled``: the
              cotangent summed over the group, this rank's slice kept (a
              reduce-scatter, 1/n of an all-reduce's result).  ZeRO-3's
              gather before use (``sharding/rules.py::compute_view``), so
              a sharded parameter's gradient arrives summed and sharded.
  reduce_scatter_tiled  forward the sum over the group, this rank's
              slice kept; backward ``all_gather_tiled`` of the cotangent.
              The exit of a row-parallel product under sequence
              parallelism (the residual stream's S over ``model``).
  replicated  the entry of a tensor that every rank of the group holds
              (h): identity forward, its cotangent summed over the group
              backward, as shard_map's transpose does for a replicated
              input.  Without it each rank's dL/dh holds only its own
              shard's terms.
  all_gather_replicated, split_tiled  the tiled all-gather and its
              inverse between S-shards and a tensor every rank holds
              whole with a whole cotangent (replicated compute after it):
              the first's backward keeps this rank's slice of the
              cotangent, the second's all-gathers it.

``merge_softmax`` joins the parts of a softmax whose keys are split over
the group (decode's attention over a sequence-sharded KV cache): one pmax
of the parts' maxima and one psum of their rescaled [sum | output].

Every call is counted (``collective_counts``: calls and bytes per op).
Random draws take a ``torch.Generator`` where the reference takes a key;
``utils.misc.fold_generator`` folds the shard index in as the reference
folds ``axis_index`` into its key.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.estimators import Estimator
from repro_torch.core.sampled_softmax import _log_m, transform_logits
from repro_torch.core.samplers import (
    Sampler,
    categorical_rows,
    pool_log_inclusion,
)
from repro_torch.kernels import ops
from repro_torch.utils.misc import fold_generator, top_k

Tensor = torch.Tensor

# --- collectives --------------------------------------------------------------

_COUNTS: dict[tuple[str, str], list[int]] = {}
#: id(group) -> its name (``label_group``; a mesh's axes)
_GROUP_NAMES: dict[int, str] = {}


def label_group(group, name: str):
    """Name ``group`` in ``collective_counts(by_group=True)`` (the mesh's
    axes it runs over: ``sharding.rules.ShardCtx.group``); returns it."""
    if group is not None:
        _GROUP_NAMES[id(group)] = name
    return group


def collective_counts(by_group: bool = False
                      ) -> dict[str, dict[str, int]]:
    """Collectives since the last reset: {op: {"calls", "bytes"}}, bytes
    being the size of each call's result on this rank; ``by_group``
    keys them ``"<op> <group>"`` by the group's name (``label_group``;
    else its global ranks): ``"all_gather data"``."""
    out: dict[str, dict[str, int]] = {}
    for (op, group), (c, b) in _COUNTS.items():
        key = f"{op} {group}" if by_group else op
        got = out.setdefault(key, {"calls": 0, "bytes": 0})
        got["calls"] += c
        got["bytes"] += b
    return out


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _count(op: str, t: Tensor, group) -> None:
    name = _GROUP_NAMES.get(id(group)) or ",".join(
        map(str, dist.get_process_group_ranks(group)))
    c = _COUNTS.setdefault((op, name), [0, 0])
    c[0] += 1
    c[1] += t.numel() * t.element_size()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce_(x: Tensor, op: str, group) -> Tensor:
    """In-place all-reduce of a contiguous ``x`` over ``group``, counted."""
    _count(f"all_reduce_{op}", x, group)
    dist.all_reduce(x, op=_OPS[op], group=group)
    return x


def _gather(x: Tensor, group, dim: int) -> Tensor:
    parts = [torch.empty_like(x) for _ in range(axis_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    out = torch.cat(parts, dim=dim)
    _count("all_gather", out, group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), "sum", ctx.group), None


def _reduce_scatter(x: Tensor, group, dim: int) -> Tensor:
    xt = x.movedim(dim, 0).contiguous()
    n = axis_size(group)
    if xt.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {n} ranks")
    out = xt.new_empty((xt.shape[0] // n, *xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=group)
    _count("reduce_scatter", out, group)
    return out.movedim(0, dim).contiguous()


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatterTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


def _own_slice(x: Tensor, group, dim: int) -> Tensor:
    n = axis_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(group) * size, size).contiguous()


class _AllGatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group, ctx.dim), None, None


class _SplitTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


def psum(x: Tensor, group) -> Tensor:
    """Sum over the group; the backward passes the cotangent through."""
    return x if group is None else _PSum.apply(x, group)


def pmax(x: Tensor, group) -> Tensor:
    """Max over the group, of values with no gradient."""
    if group is None:
        return x.detach()
    return all_reduce_(x.detach().contiguous().clone(), "max", group)


def pmin(x: Tensor, group) -> Tensor:
    """Min over the group, of values with no gradient."""
    if group is None:
        return x.detach()
    return all_reduce_(x.detach().contiguous().clone(), "min", group)


def all_gather_tiled(x: Tensor, group, dim: int = 0) -> Tensor:
    """The group's parts concatenated along ``dim`` in rank order
    (``lax.all_gather(..., tiled=True)``); differentiable for float x."""
    if group is None:
        return x
    if x.is_floating_point() and x.requires_grad:
        return _AllGatherTiled.apply(x, group, dim)
    return _gather(x.detach(), group, dim)


def reduce_scatter_tiled(x: Tensor, group, dim: int = 0) -> Tensor:
    """The sum of ``x`` over the group, of which this rank keeps its
    ``dim``-slice in rank order (the transpose of ``all_gather_tiled``);
    differentiable for float x (the backward all-gathers the cotangent)."""
    if group is None:
        return x
    if x.is_floating_point() and x.requires_grad:
        return _ReduceScatterTiled.apply(x, group, dim)
    return _reduce_scatter(x.detach(), group, dim)


def all_gather_replicated(x: Tensor, group, dim: int = 0) -> Tensor:
    """``all_gather_tiled`` into a tensor that every rank then computes on
    alike: its cotangent is whole on every rank, so the backward keeps
    this rank's slice of it and communicates nothing (Megatron's
    sequence-parallel gather with a split backward)."""
    if group is None:
        return x
    if x.is_floating_point() and x.requires_grad:
        return _AllGatherReplicated.apply(x, group, dim)
    return _gather(x.detach(), group, dim)


def split_tiled(x: Tensor, group, dim: int = 0) -> Tensor:
    """This rank's ``dim``-slice of a tensor every rank holds alike (the
    inverse of ``all_gather_replicated``): no collective forward, the
    cotangent's slices all-gathered backward."""
    if group is None:
        return x
    if x.is_floating_point() and x.requires_grad:
        return _SplitTiled.apply(x, group, dim)
    return _own_slice(x, group, dim)


def replicated(x: Tensor, group) -> Tensor:
    """Mark ``x`` as held alike by every rank of ``group``: its gradient
    is summed over the group (see the module docstring)."""
    return x if group is None else _Replicated.apply(x, group)


@torch.no_grad()
def merge_softmax(m: Tensor, l: Tensor, o: Tensor, group) -> Tensor:
    """A softmax-weighted sum whose keys lie split over ``group``: each
    rank holds, over its own keys, the max score m (...,) (-inf where it
    has no valid key), the sum l (...,) of exp(score - m) and the output
    o (..., hv) = sum exp(score - m) v.  One pmax gives the global max M,
    and one psum of [l | o] rescaled by exp(m - M) gives the global sum and
    output: returns output / sum.  Off a group (None) o / l."""
    if group is None:
        return o / l[..., None]
    big = pmax(m, group)
    scale = torch.exp(torch.where(torch.isneginf(m), -torch.inf, m - big))
    parts = torch.cat([(l * scale)[..., None], o * scale[..., None]],
                      dim=-1)
    parts = psum(parts, group)
    return parts[..., 1:] / parts[..., :1]


# --- shard geometry -----------------------------------------------------------


def axis_size(group) -> int:
    """The group's shard count (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def axis_index(group) -> int:
    """This rank's shard index in the group: the order of
    ``all_gather_tiled``, so pool order and vocab offsets agree."""
    return 0 if group is None else dist.get_rank(group)


def local_vocab_offset(n_local: int, group) -> int:
    return axis_index(group) * n_local


def local_labels(w_local: Tensor, labels: Tensor, group) -> Tensor:
    """Global label ids -> this shard's local row ids (out of range on
    non-owner shards, which only ever compare them against LOCAL negative
    ids, so a non-owner can never match): the label side of the
    accidental-hit rule."""
    return labels - local_vocab_offset(w_local.shape[0], group)


# --- sampled losses -----------------------------------------------------------


def sharded_negative_sample(sampler: Sampler, state_local: Any, h: Tensor,
                            m: int, gen: torch.Generator, group
                            ) -> tuple[Tensor, Tensor]:
    """Stratified sampling: each shard draws m/tp from its local
    distribution, with ``gen`` folded by the shard index.  Returns LOCAL
    ids (.., m/tp) and the GLOBAL log q~ = log q_local - log tp.  No
    gradient reaches the sampler."""
    tp = axis_size(group)
    assert m % tp == 0, f"m={m} must divide by the TP degree {tp}"
    with torch.no_grad():
        ids, logq_local = sampler.sample_batch(
            state_local, h.detach(), m // tp,
            fold_generator(gen, axis_index(group)))
    return ids, logq_local - math.log(tp)


def _positive_logit(w_local: Tensor, h: Tensor, labels: Tensor, group,
                    bias_local: Tensor | None = None,
                    logits: Tensor | None = None) -> Tensor:
    """Logit of each example's positive class, summed over the shards:
    exactly one shard owns each label, the others contribute zero.  Read
    off this shard's (T, n/tp) ``logits`` where given (as the one-device
    full softmax gathers it), else from the owned rows of ``w_local``."""
    n_local = w_local.shape[0]
    off = local_vocab_offset(n_local, group)
    local = (labels >= off) & (labels < off + n_local)
    idx = torch.clamp(labels - off, 0, n_local - 1).long()
    if logits is not None:
        logit = torch.gather(logits, 1, idx[:, None])[:, 0]
    else:
        logit = torch.einsum("td,td->t", h.float(), w_local[idx].float())
        if bias_local is not None:
            logit = logit + bias_local[idx]
    logit = torch.where(local, logit, 0.0)
    return psum(logit, group)


def sharded_sampled_softmax_loss(
        w_local: Tensor, h: Tensor, labels: Tensor, sampler: Sampler,
        state_local: Any, m: int, gen: torch.Generator, *, group,
        abs_mode: bool = False, bias_local: Tensor | None = None,
        mask_accidental_hits: bool = True, impl: str = "auto") -> Tensor:
    """Sampled softmax over a vocab-sharded head, negatives sampled in
    place.  w_local: (n/tp, d) this shard; h: (T, d) and labels (T,)
    GLOBAL ids, alike on every rank of the group; m: negatives over all
    shards (divisible by tp).  Returns the per-example loss (T,).

    A negative that collided with the label (only on the shard owning the
    label row) is masked to zero mass after the eq. 2 correction unless
    ``mask_accidental_hits=False``.  Per-example negatives go through the
    fused head (``ops.fused_head_lse``: this shard's corrected logsumexp,
    ``fused_lse`` / ``fused_lse_bwd`` on the card) unless
    ``impl="einsum"``.  Communication: two psums of (T,) (the positive
    logit and the partition) and one pmax."""
    h32 = h.float()
    neg_ids, logq = sharded_negative_sample(sampler, state_local, h, m, gen,
                                            group)
    pos = transform_logits(
        _positive_logit(w_local, h, labels, group, bias_local), abs_mode)
    labels_local = local_labels(w_local, labels, group)

    if neg_ids.dim() == 2 and impl != "einsum":
        # eq. 2 with stratified correction: E[count] = m_local q_local = m q~
        corr = (logq + _log_m(m, logq.float())).float()
        if mask_accidental_hits:
            corr = torch.where(neg_ids == labels_local[:, None],
                               ops.MASK_CORR, corr)
        biasg = bias_local[neg_ids] if bias_local is not None else None
        lse_local = ops.fused_head_lse(
            w_local, h32, neg_ids, corr, biasg, abs_mode=abs_mode,
            impl="auto" if impl == "fused" else impl)
        c = pmax(torch.maximum(lse_local.detach(), pos.detach()), group)
        sumexp = psum(torch.exp(lse_local - c), group) + torch.exp(pos - c)
        return torch.log(sumexp) + c - pos

    o_adj = _corrected_neg_logits(
        w_local, h32, labels, neg_ids, logq, m, group=group,
        abs_mode=abs_mode, bias_local=bias_local,
        mask_hits=mask_accidental_hits)
    # Stable global logsumexp over [pos, every shard's negatives]; the
    # shift needs no gradient (it cancels analytically).
    local_max = torch.amax(o_adj.detach(), dim=-1)
    c = pmax(torch.maximum(local_max, pos.detach()), group)
    sumexp_local = torch.sum(torch.exp(o_adj - c[:, None]), dim=-1)
    sumexp = psum(sumexp_local, group) + torch.exp(pos - c)
    return torch.log(sumexp) + c - pos


def _corrected_neg_logits(w_local: Tensor, h32: Tensor, labels: Tensor,
                          neg_ids: Tensor, logq: Tensor, m: int, *, group,
                          abs_mode: bool, bias_local: Tensor | None,
                          mask_hits: bool) -> Tensor:
    """Shard-local eq.-2-corrected negative logits (T, m/tp): gather,
    logit, bias, |.|, ``o - logq - ln m`` and the accidental-hit mask, for
    every estimator's einsum path.  Masked slots are -inf: zero mass in
    the partition AND zero value and gradient under softplus."""
    w_neg = w_local[neg_ids].float()
    if neg_ids.dim() == 1:  # batch-shared negatives: (m/tp, d)
        o_neg = torch.einsum("td,md->tm", h32, w_neg)
        logq_b = torch.broadcast_to(logq[None, :], o_neg.shape)
        nb = neg_ids[None, :]
    else:  # per-example negatives: (T, m/tp, d)
        o_neg = torch.einsum("td,tmd->tm", h32, w_neg)
        logq_b = logq
        nb = neg_ids
    if bias_local is not None:
        o_neg = o_neg + bias_local[nb]
    o_adj = transform_logits(o_neg, abs_mode) - logq_b - _log_m(m, o_neg)
    if mask_hits:
        labels_local = local_labels(w_local, labels, group)
        o_adj = torch.where(nb == labels_local[:, None], -math.inf, o_adj)
    return o_adj


def sharded_tapas_negatives(sampler: Sampler, state_local: Any,
                            w_local: Tensor, h: Tensor, m: int,
                            gen: torch.Generator, *, group,
                            bias_local: Tensor | None = None
                            ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The two-pass "sample -> all-gather pool -> re-score" pattern
    (DESIGN.md §2.8), one shard's view.

    Pass 1: this shard draws pool/tp candidates from its LOCAL base
    distribution (batch-shared bases their batch-summed draw, per-example
    bases from the mean query).  A class's global inclusion probability is
    its inclusion on the one shard that owns it, so ``pool_log_inclusion``
    takes the LOCAL per-draw log q1 with pool/tp draws: no /tp.
    All-gather over the group: global ids, log pi, embedding rows (+ bias).
    Pass 2: re-score the replicated pool (one (T, pool) matmul), then draw
    m/tp slots per shard from the SAME composed global q.

    ``gen`` splits as the reference's key: ``fold_generator(gen, 0)`` for
    the pool, ``fold_generator(gen, 1)`` for the slots, each folded again
    by the shard index.  Returns (pool_gids (pool,), o (T, pool) raw pool
    logits CARRYING GRADIENT through the gathered rows, slots (T, m/tp),
    logq (T, m/tp) composed log-probabilities, no gradient)."""
    tp = axis_size(group)
    assert m % tp == 0, f"m={m} must divide by the TP degree {tp}"
    pool = sampler.pool
    assert pool % tp == 0, f"pool={pool} must divide by the TP degree {tp}"
    m_local, p_local = m // tp, pool // tp
    me = axis_index(group)
    g_pool = fold_generator(fold_generator(gen, 0), me)
    with torch.no_grad():
        base_rt, hd = state_local["base"], h.detach()
        if sampler.base.shares_negatives:
            pids, lq1 = sampler.base.sample_batch(base_rt, hd, p_local,
                                                  g_pool)
        else:
            pids, lq1 = sampler.base.sample(base_rt, torch.mean(hd, dim=0),
                                            p_local, g_pool)
        logpi_l = pool_log_inclusion(lq1, p_local)
    gids_l = pids + local_vocab_offset(w_local.shape[0], group)
    pool_w = all_gather_tiled(w_local[pids], group)
    pool_gids = all_gather_tiled(gids_l, group)
    pool_logpi = all_gather_tiled(logpi_l, group)
    o = h.float() @ pool_w.float().T
    if bias_local is not None:
        o = o + all_gather_tiled(bias_local[pids], group)[None, :]
    with torch.no_grad():
        counts = torch.bincount(pool_gids.long(),
                                minlength=w_local.shape[0] * tp)
        mult = counts[pool_gids.long()]  # multiplicity: O(P), not P^2
        o_sg = o.detach() / sampler.tau
        s = o_sg - (pool_logpi + torch.log(mult.float()))[None, :]
        slots = categorical_rows(fold_generator(fold_generator(gen, 1), me),
                                 s, m_local)
        logq = (torch.gather(o_sg, 1, slots)
                - torch.logsumexp(s, dim=-1, keepdim=True))
    return pool_gids, o, slots, logq


def _sharded_tapas_loss(
        est: Estimator, w_local: Tensor, h: Tensor, labels: Tensor,
        sampler: Sampler, state_local: Any, m: int, gen: torch.Generator,
        *, group, abs_mode: bool, bias_local: Tensor | None) -> Tensor:
    """Estimator loss over tapas negatives (per-example (T,)): the m/tp
    per-shard draws come from one GLOBAL q, so the corrected logits are
    ``o - logq - ln m`` on every shard; pmax + psum logsumexp for
    sampled-softmax, a psum of softplus sums for the logistic family."""
    if est.name not in ("sampled-softmax", "nce", "sampled-logistic"):
        raise NotImplementedError(
            f"estimator '{est.name}' has no sharded tapas routing; add it "
            "to _sharded_tapas_loss")
    pos = transform_logits(
        _positive_logit(w_local, h, labels, group, bias_local), abs_mode)
    pool_gids, o, slots, logq = sharded_tapas_negatives(
        sampler, state_local, w_local, h, m, gen, group=group,
        bias_local=bias_local)
    o_sel = torch.gather(o, 1, slots)                     # (T, m/tp), grads
    o_adj = transform_logits(o_sel, abs_mode) - logq - _log_m(m, o_sel)
    hit = pool_gids[slots] == labels[:, None]
    if est.masks_hits:
        o_adj = torch.where(hit, -math.inf, o_adj)
    if est.name == "sampled-softmax":
        local_max = torch.amax(o_adj.detach(), dim=-1)
        c = pmax(torch.maximum(local_max, pos.detach()), group)
        sumexp = (psum(torch.sum(torch.exp(o_adj - c[:, None]), dim=-1),
                       group) + torch.exp(pos - c))
        return torch.log(sumexp) + c - pos
    neg_sum = psum(torch.sum(F.softplus(o_adj), dim=-1), group)
    return F.softplus(-pos) + neg_sum


def sharded_estimator_loss(
        est: Estimator, w_local: Tensor, h: Tensor, labels: Tensor,
        sampler: Sampler, state_local: Any, m: int, gen: torch.Generator,
        *, group, abs_mode: bool = False, bias_local: Tensor | None = None,
        impl: str = "auto") -> Tensor:
    """Estimator-routed vocab-sharded loss (DESIGN.md §6): the shard-local
    sampling and communication each estimator needs, behind one call.

      sampled-softmax  -> ``sharded_sampled_softmax_loss`` (one pmax + two
                          psums of (T,)).
      nce / sampled-logistic -> the logistic sum decomposes PER SHARD: the
                          positive-logit psum plus one psum of the (T,)
                          per-shard softplus sums.
      full             -> ``sharded_full_softmax_loss``.

    Two-stage samplers divert to the tapas pool pattern first.  Returns the
    per-example (T,) loss."""
    if not est.needs_sampling:
        return sharded_full_softmax_loss(
            w_local, h, labels, group=group, abs_mode=abs_mode,
            bias_local=bias_local)
    if sampler.two_stage:
        return _sharded_tapas_loss(
            est, w_local, h, labels, sampler, state_local, m, gen,
            group=group, abs_mode=abs_mode, bias_local=bias_local)
    if est.name == "sampled-softmax":
        return sharded_sampled_softmax_loss(
            w_local, h, labels, sampler, state_local, m, gen, group=group,
            abs_mode=abs_mode, bias_local=bias_local, impl=impl)
    # An explicit allowlist: an estimator with its own loss() must grow
    # its own sharded routing, not inherit the logistic formula.
    if est.name not in ("nce", "sampled-logistic"):
        raise NotImplementedError(
            f"estimator '{est.name}' has no sharded routing; add it to "
            "sharded_estimator_loss")
    neg_ids, logq = sharded_negative_sample(sampler, state_local, h, m, gen,
                                            group)
    pos = transform_logits(
        _positive_logit(w_local, h, labels, group, bias_local), abs_mode)
    o_adj = _corrected_neg_logits(
        w_local, h.float(), labels, neg_ids, logq, m, group=group,
        abs_mode=abs_mode, bias_local=bias_local, mask_hits=est.masks_hits)
    neg_sum = psum(torch.sum(F.softplus(o_adj), dim=-1), group)
    return F.softplus(-pos) + neg_sum


def _local_logits(w_local: Tensor, h: Tensor,
                  bias_local: Tensor | None) -> Tensor:
    logits = torch.einsum("td,nd->tn", h.float(), w_local.float())
    if bias_local is not None:
        logits = logits + bias_local[None, :]
    return logits


def sharded_full_softmax_loss(w_local: Tensor, h: Tensor, labels: Tensor,
                              *, group, abs_mode: bool = False,
                              bias_local: Tensor | None = None) -> Tensor:
    """Full softmax over the sharded vocab (the dense oracle): only (T,
    n/tp) logits per shard.  The positive logit is read off the owning
    shard's logits, so a group of one shard computes what
    ``full_softmax_loss`` computes, op for op."""
    raw = _local_logits(w_local, h, bias_local)
    logits = transform_logits(raw, abs_mode)
    c = pmax(torch.amax(logits.detach(), dim=-1), group)
    sumexp = psum(torch.sum(torch.exp(logits - c[:, None]), dim=-1), group)
    pos = _positive_logit(w_local, h, labels, group, logits=raw)
    return torch.log(sumexp) + c - transform_logits(pos, abs_mode)


@torch.no_grad()
def sharded_logits_argmax(w_local: Tensor, h: Tensor, *, group,
                          bias_local: Tensor | None = None
                          ) -> tuple[Tensor, Tensor]:
    """Greedy decode over a sharded head: global (argmax id int32, max
    logit).  Communication: one pmax of (T,) and one pmin of (T,) ids
    (ties to the lowest id: each shard's first maximum, then the lowest
    shard among the winners)."""
    logits = _local_logits(w_local, h, bias_local)
    off = local_vocab_offset(w_local.shape[0], group)
    local_best = torch.amax(logits, dim=-1)
    local_arg = torch.argmax(logits, dim=-1).to(torch.int32) + off
    best = pmax(local_best, group)
    candidate = torch.where(local_best >= best, local_arg,
                            torch.iinfo(torch.int32).max)
    return pmin(candidate, group), best


@torch.no_grad()
def sharded_logits_topk(w_local: Tensor, h: Tensor, k: int, *, group,
                        bias_local: Tensor | None = None
                        ) -> tuple[Tensor, Tensor]:
    """Dense top-k decode over a sharded head: global (ids (T, k) int32,
    logits (T, k) fp32), sorted.  Communication: one all-gather of each
    shard's (T, k) candidates, never a gathered (T, n) logit tensor.  Ties
    resolve toward the lowest shard, then the lowest local row (matching
    ``sharded_logits_argmax`` at k = 1)."""
    logits = _local_logits(w_local, h, bias_local)
    n_local = w_local.shape[0]
    off = local_vocab_offset(n_local, group)
    local_best, local_arg = top_k(logits, min(k, n_local))
    local_ids = local_arg.to(torch.int32) + off
    all_best = all_gather_tiled(local_best, group, dim=1)
    all_ids = all_gather_tiled(local_ids, group, dim=1)
    best, sel = top_k(all_best, k)
    return torch.gather(all_ids, 1, sel), best


@torch.no_grad()
def sharded_partition_diagnostics(state_local: Any, sampler: Sampler,
                                  h: Tensor, *, group) -> Tensor:
    """Per-shard share of the global kernel mass (load-balance
    telemetry): rho_s = sum_b alpha h^T Z_b h + n_s over the shard's
    root-level statistics (blocks, or a hierarchy's root), normalized over
    the shards.  (T,) fraction owned by this shard."""
    stats = state_local["stats"]
    proj = state_local.get("proj")
    hq = h.float()
    if proj is not None:
        hq = hq @ proj.T
    if hasattr(stats, "levels_z"):  # hierarchy / tree statistics
        z, cnt = stats.levels_z[0], stats.levels_cnt[0]
    else:  # two-level block statistics
        z, cnt = stats.z, stats.cnt
    quad = torch.einsum("nij,ti,tj->tn", z, hq, hq)
    mass = torch.sum(sampler.kernel.alpha * quad + cnt[None, :], dim=-1)
    return mass / psum(mass, group)
