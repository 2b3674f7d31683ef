"""Mixture-of-Experts FFN of the port (``repro.models.moe``), the
mesh-free path.

Dispatch is capacity-based, as in the reference (GShard semantics): each
expert takes at most ``capacity`` assignments, ranked in the order of
``ids.reshape(-1)`` over the (T, k) routing, i.e. token-major; later ones
are dropped.  Kept slots are unique, so dispatch copies each kept token
into its slot (no float atomics).  The experts run as batched products over
their (E, capacity, d) slots, every expert every call, empty slots
included.  Combine adds the k contributions in the order j = 0..k-1 in
x's dtype, a dropped assignment adding 0.  Expert parallelism over a mesh
arrives with ROADMAP.md A17.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import _pdtype, dense_init
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
                              cfg: ArchConfig, cap: int) -> Tensor:
    """Slot tokens into the experts' (E, cap) slots, run them, combine
    back: (T, d) in x's dtype."""
    t, d = x2d.shape
    e = wg.shape[0]
    slot, keep = _slots(ids, e, cap)
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


def apply_moe(p: Params, x: Tensor, cfg: ArchConfig, ctx=None
              ) -> tuple[Tensor, Tensor]:
    """MoE FFN.  x: (B, S, d).  Returns (y (B, S, d), aux_loss)."""
    if ctx is not None and getattr(ctx, "mesh", None) is not None:
        raise NotImplementedError("expert parallelism over a mesh is not "
                                  "ported yet (ROADMAP.md A17)")
    b, s, d = x.shape
    dt = x.dtype
    x2d = x.reshape(b * s, d)
    ids, w, aux = _route(p, x2d, cfg)
    y = _dispatch_compute_combine(
        x2d, ids, w, p["w_gate"].to(dt), p["w_up"].to(dt),
        p["w_down"].to(dt), cfg, capacity(b * s, cfg)).reshape(b, s, d)
    if cfg.n_shared_experts:
        sh = p["shared"]
        up = x @ sh["w_up"].to(dt)
        if cfg.act == "silu":
            h = F.silu(x @ sh["w_gate"].to(dt)) * up
        else:
            h = F.gelu(up, approximate="tanh")
        y = y + h @ sh["w_down"].to(dt)
    return y, aux
