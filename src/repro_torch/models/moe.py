"""Mixture-of-Experts FFN of the port (``repro.models.moe``).

Dispatch is capacity-based, as in the reference (GShard semantics): each
expert takes at most ``capacity`` assignments, ranked in the order of
``ids.reshape(-1)`` over the (T, k) routing, i.e. token-major; later ones
are dropped.  Kept slots are unique, so dispatch copies each kept token
into its slot (no float atomics).  The experts run as batched products over
their (E, capacity, d) slots, every expert every call, empty slots
included.  Combine adds the k contributions in the order j = 0..k-1 in
x's dtype, a dropped assignment adding 0.

On a ``(data, model)`` mesh in tp_fsdp (``apply_moe(..., ctx)``; the
reference's shard_map branch) a model rank owns the experts
``[e_lo, e_lo + E / tp)``, ``e_lo = model position * E / tp``: their
``w_gate`` / ``w_up`` / ``w_down`` shards (the ``M`` rule on the expert
dim), gathered whole over ``data`` by ``rules.compute_view`` (ZeRO-3).
The layer's input enters as the tensor-parallel blocks' does
(``layers.tp_enter``: Megatron's f, or the all-gather of S under sequence
parallelism), so every model rank routes the same whole token set of its
data rows; the capacity comes from those rows alone (``t_local``), so the
mesh drops per data shard exactly as the mesh-free layer would on that
shard's rows.  Each rank dispatches to, runs and combines its own experts
(the same slots the whole layer gives them), the shared experts' Megatron
column/row-parallel partial sums join that partial output, and ONE
reduction over ``model`` (``layers.tp_exit``: a psum, or a reduce-scatter
over S) combines both.  aux is the mean over ``data`` of each data
shard's (alike on its model ranks).  Each model rank's router gradient
is a part (its experts' combine weights only): the train step sums it
over ``model`` as well as ``data`` (``rules.model_partial``).
pure_fsdp with experts raises, as the reference asserts.

Serving (``rules.ctx_for_serve``) runs the same layer in its two modes:
in ``tp`` (jamba-v0.1-52b) the experts' stored shards are whole along
``Fd`` (the reference's ``_allgather_fsdp`` is a no-op there), so
nothing is gathered; in tp_fsdp (``serve_fsdp``: dbrx-132b,
deepseek-v3-671b) they are gathered over ``data`` per layer as in
training.  A batch that dp does not divide is whole on every data rank
(``rules.serve_rows``), so its capacity comes from the whole batch, as
the reference's replicated-token branch takes it.  In tp mode the
reference's layer takes its tokens replicated over ``data`` (its token
spec is the weights' ``Fd``, none there) with the capacity of a data
block's tokens, so a rank there routes every data block's tokens
(``gather_rows``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import distributed
from repro_torch.models.layers import _pdtype, dense_init, tp_enter, tp_exit
from repro_torch.sharding import rules
from repro_torch.utils.misc import top_k

Tensor = torch.Tensor
Params = dict


def init_moe(gen: torch.Generator, cfg: ArchConfig,
             device: torch.device) -> Params:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    pd = _pdtype(cfg)
    p = {
        "router": dense_init(gen, (d, e), torch.float32, device, scale=0.02),
        "w_gate": dense_init(gen, (e, d, f), pd, device, scale=d ** -0.5),
        "w_up": dense_init(gen, (e, d, f), pd, device, scale=d ** -0.5),
        "w_down": dense_init(gen, (e, f, d), pd, device, scale=f ** -0.5),
    }
    if cfg.router_scale:  # deepseek-style sigmoid scoring bias
        p["router_bias"] = torch.zeros((e,), dtype=torch.float32,
                                       device=device)
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w_gate": dense_init(gen, (d, fs), pd, device),
                       "w_up": dense_init(gen, (d, fs), pd, device),
                       "w_down": dense_init(gen, (fs, d), pd, device)}
    return p


def _route(p: Params, x2d: Tensor, cfg: ArchConfig
           ) -> tuple[Tensor, Tensor, Tensor]:
    """Top-k routing in fp32.  Returns (expert ids (T, k) int64, weights
    (T, k) in x's dtype, the Switch-style aux loss).  Experts are ranked
    with ``top_k``: the lowest expert id wins a tie."""
    logits = x2d.float() @ p["router"]  # (T, E)
    k = cfg.moe_top_k
    if cfg.router_scale:
        scores = torch.sigmoid(logits)
        _, ids = top_k(scores + p["router_bias"], k)
        raw = torch.gather(scores, 1, ids)
        w = raw / torch.clamp(raw.sum(-1, keepdim=True), min=1e-9)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        topw, ids = top_k(probs, k)
        w = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    # the reference's aux: ce is the mean over experts of the top-1 counts
    # over T, a scalar
    e = logits.shape[-1]
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.bincount(ids[:, 0], minlength=e).float()
                    / logits.shape[0])
    aux = e * torch.sum(me * ce)
    return ids, w.to(x2d.dtype), aux


def capacity(t: int, cfg: ArchConfig) -> int:
    """Slots per expert for T tokens (the reference's rule)."""
    k = cfg.moe_top_k
    return int(max(k, math.ceil(t * k / cfg.n_experts
                                * cfg.capacity_factor)))


def _slots(ids: Tensor, n_experts: int, cap: int) -> tuple[Tensor, Tensor]:
    """(slot (T, k), keep (T, k)) of each assignment: its expert's rank of
    it among that expert's assignments in ``ids.reshape(-1)`` order, kept
    below ``cap``; slot = expert * cap + rank, or E * cap where dropped."""
    flat = ids.reshape(-1).long()
    onehot = F.one_hot(flat, n_experts)
    pos = torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot, dim=-1)
    keep = pos < cap
    slot = torch.where(keep, flat * cap + pos, n_experts * cap)
    return slot.reshape(ids.shape), keep.reshape(ids.shape)


def _expert_compute(xe: Tensor, wg: Tensor, wu: Tensor, wd: Tensor,
                    act: str) -> Tensor:
    """xe: (E, C, d) -> (E, C, d) through each expert's FFN."""
    up = torch.bmm(xe, wu)
    if act == "silu":
        h = F.silu(torch.bmm(xe, wg)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return torch.bmm(h, wd)


def _dispatch_compute_combine(x2d: Tensor, ids: Tensor, w: Tensor,
                              wg: Tensor, wu: Tensor, wd: Tensor,
                              cfg: ArchConfig, cap: int, e_lo: int = 0
                              ) -> Tensor:
    """Slot tokens into the (E_l, cap) slots of the experts ``[e_lo, e_lo
    + E_l)`` (E_l = ``wg.shape[0]``; the whole layer's slots, those
    experts' share of them), run them, combine back: those experts'
    contribution (T, d) in x's dtype, the layer's output where they are
    all of them."""
    t, d = x2d.shape
    e = wg.shape[0]
    slot, keep = _slots(ids, cfg.n_experts, cap)
    if e != cfg.n_experts:
        keep = keep & (ids >= e_lo) & (ids < e_lo + e)
        slot = torch.where(keep, slot - e_lo * cap, e * cap)
    xe = x2d.new_zeros((e * cap + 1, d))
    kept = keep.reshape(-1).nonzero()[:, 0]
    xe[slot.reshape(-1)[kept]] = x2d[kept // cfg.moe_top_k]
    ye = _expert_compute(xe[:-1].reshape(e, cap, d), wg, wu, wd, cfg.act)
    ye = torch.cat([ye.reshape(e * cap, d), ye.new_zeros((1, d))])
    y = x2d.new_zeros((t, d))
    for j in range(cfg.moe_top_k):
        contrib = ye[slot[:, j]] * w[:, j:j + 1]
        y = y + torch.where(keep[:, j:j + 1], contrib, 0.0)
    return y


def dropped(ids: Tensor, cfg: ArchConfig, cap: int, e_lo: int = 0,
            e_l: int | None = None) -> int:
    """Assignments of a routing ``ids`` (T, k) to the experts ``[e_lo,
    e_lo + e_l)`` (all of them by default) that the capacity ``cap``
    drops."""
    _, keep = _slots(ids, cfg.n_experts, cap)
    e_l = cfg.n_experts if e_l is None else e_l
    mine = (ids >= e_lo) & (ids < e_lo + e_l)
    return int((mine & ~keep).sum())


def _shared(sh: Params, x: Tensor, cfg: ArchConfig) -> Tensor:
    """The shared experts' FFN of x (B, S, d); under TP this rank's
    columns' partial sums."""
    dt = x.dtype
    up = x @ sh["w_up"].to(dt)
    if cfg.act == "silu":
        h = F.silu(x @ sh["w_gate"].to(dt)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ sh["w_down"].to(dt)


def moe_rows(ctx, rows: int, batch: int | None) -> bool:
    """Whether a serving rank's MoE layers gather their tokens over
    ``data`` (``apply_moe``'s ``gather_rows``): in tp mode at dp > 1 where
    its ``rows`` are its block of a batch of ``batch`` split over ``data``
    (``rules.serve_rows``).  ``batch`` may be None where ``rows`` tells
    it: dp dividing ``rows`` means a block (a whole batch is split
    wherever dp divides it)."""
    if not rules.on_mesh(ctx) or ctx.mode != "tp" or ctx.dp == 1:
        return False
    if batch is None:
        if rows % ctx.dp:
            raise ValueError(
                f"{rows} rows a data rank in tp mode: a block of a batch "
                f"of {rows * ctx.dp} or a whole batch of {rows}?  The MoE "
                "layers take the whole batch (batch=)")
        return True
    return batch % ctx.dp == 0


def _mesh_aux(aux: Tensor, ctx) -> Tensor:
    """aux's mean over the data shards (the reference's pmean over
    ``model``, whose ranks hold it alike, and ``data``), its gradient the
    rank's own aux over tp * dp: the train step sums the router's and x's
    gradients over both, which gives the mean's gradient."""
    n = ctx.tp * ctx.axis_size(ctx.data_axes)
    mean = distributed.psum(aux.detach(), ctx.data_group) / ctx.axis_size(
        ctx.data_axes)
    own = aux / n
    return own + (mean - own).detach()


def apply_moe(p: Params, x: Tensor, cfg: ArchConfig, ctx=None,
              seq: bool = False, mesh_aux: bool = True,
              gather_rows: bool = False) -> tuple[Tensor, Tensor]:
    """MoE FFN.  x: (B, S, d).  Returns (y (B, S, d), aux_loss).  On a
    mesh (a ``ShardCtx``; the module docstring) ``p`` is the layer's
    compute view, its experts this rank's, and x this rank's data rows
    (with ``seq`` their S-shard: y is too).  ``mesh_aux=False`` (serving,
    which drops aux) returns this rank's own aux, not its mean over
    ``data``.  ``gather_rows`` (serving in tp mode, x this rank's block of
    a batch split over ``data``): the tokens of every data block are
    routed, as the reference's tp-mode layer replicates its tokens over
    ``data`` (its ``dataspec`` is the weights' ``Fd``, none in tp), with
    the capacity of this rank's block: x is all-gathered over ``data``
    (``moe_rows``) and this rank's block of the output kept."""
    mesh = rules.on_mesh(ctx)
    if mesh and ctx.mode == "pure_fsdp":
        raise ValueError("MoE archs must use tp_fsdp sharding (experts live "
                         "on `model`)")
    group = rules.tp_group(ctx)
    e_l = p["w_gate"].shape[0]
    if mesh and e_l * ctx.tp != cfg.n_experts:
        raise ValueError(f"{cfg.n_experts} experts over tp {ctx.tp}: a "
                         f"rank holds {e_l}")
    x = tp_enter(x, group, seq)
    b, s, d = x.shape
    dt = x.dtype
    x_in = (distributed.all_gather_tiled(x, ctx.data_group, dim=0)
            if gather_rows else x)
    x2d = x_in.reshape(-1, d)
    ids, w, aux = _route(p, x2d, cfg)
    y = _dispatch_compute_combine(
        x2d, ids, w, p["w_gate"].to(dt), p["w_up"].to(dt),
        p["w_down"].to(dt), cfg, capacity(b * s, cfg),
        e_lo=ctx.model_index * e_l if mesh else 0).reshape(-1, s, d)
    if gather_rows:
        y = y[ctx.data_index * b:(ctx.data_index + 1) * b]
    if cfg.n_shared_experts:
        y = y + _shared(p["shared"], x, cfg)
    if mesh and mesh_aux:
        aux = _mesh_aux(aux, ctx)
    return tp_exit(y, group, seq), aux
