"""Multi-head Latent Attention of the port (``repro.models.mla``,
DeepSeek-V2/V3).

Training and prefill use the expanded form: per head a q/k width of
``qk_nope_dim + qk_rope_dim`` and a value width of ``v_head_dim``, one
``kernels.ops.flash_attention`` call (the CUDA kernels for CUDA tensors,
their value width apart from the q/k width; the plain version for CPU
tensors).  Decode uses the absorbed form over the compressed cache: per
token one latent row of ``kv_lora_rank + qk_rope_dim`` values, against
which the query, absorbed through ``wkv_b``'s key half, attends like
GQA with one latent "KV head"; plain tensor ops in fp32, as the
reference computes it (no Pallas kernel backs it there either).

On a ``(data, model)`` mesh under TP (``mla_forward(..., group=)``, the
reference's rules) the expanded form runs over this rank's heads:
``wq_b`` and ``wkv_b`` are column-parallel over heads, ``wo``
row-parallel, and the latent projections ``wq_a`` / ``wkv_a`` and their
norms whole on every model rank (gathered over ``data``).  The input
enters and the output leaves as the other tensor-parallel blocks'
(``layers.tp_enter`` / ``tp_exit``; with ``seq`` on S-shards).  The
latents feed this rank's heads alone, so each model rank holds a part of
their leaves' gradients (``rules.model_partial``).  Serving on such a
mesh (``mla_decode(..., group=, cache_group=)``) keeps the latent cache
with its sequence over the model group, the reference's ``".bS."``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import distributed
from repro_torch.kernels import ops
from repro_torch.models import layers as L

Tensor = torch.Tensor
Params = dict


def _dims(cfg: ArchConfig, tp: int = 1) -> tuple[int, int, int, int]:
    nh = cfg.n_heads
    if nh % tp:
        nh = ((nh + tp - 1) // tp) * tp
    return nh, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim


def init_mla(gen: torch.Generator, cfg: ArchConfig, device: torch.device,
             tp: int = 1) -> Params:
    nh, nope, rpe, vh = _dims(cfg, tp)
    d, ql, kvl = cfg.d_model, cfg.q_lora_rank, cfg.kv_lora_rank
    pd = L._pdtype(cfg)

    def init(shape):
        return L.dense_init(gen, shape, pd, device)

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=device)

    return {
        "wq_a": init((d, ql)),
        "q_a_norm": {"scale": ones(ql)},
        "wq_b": init((ql, nh * (nope + rpe))),
        "wkv_a": init((d, kvl + rpe)),
        "kv_a_norm": {"scale": ones(kvl)},
        "wkv_b": init((kvl, nh * (nope + vh))),
        "wo": init((nh * vh, d)),
    }


def _queries(p: Params, x: Tensor, positions: Tensor, cfg: ArchConfig,
             dt: torch.dtype) -> tuple[Tensor, Tensor]:
    """x (B, S, d) -> q_nope (B, S, H, nope), q_rope (B, S, H, rope)."""
    b, s = x.shape[0], x.shape[1]
    nope, rpe = cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = L.rms_norm_only(x @ p["wq_a"].to(dt), p["q_a_norm"]["scale"])
    q = (cq @ p["wq_b"].to(dt)).reshape(b, s, -1, nope + rpe)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, L.rope(q_rope, positions, cfg.rope_theta)


def _latent(p: Params, x: Tensor, positions: Tensor, cfg: ArchConfig,
            dt: torch.dtype) -> tuple[Tensor, Tensor]:
    """x (B, S, d) -> c_kv (B, S, kv_lora), k_rope (B, S, rope)."""
    kvl = cfg.kv_lora_rank
    ckv = x @ p["wkv_a"].to(dt)
    c_kv = L.rms_norm_only(ckv[..., :kvl], p["kv_a_norm"]["scale"])
    k_rope = L.rope(ckv[..., None, kvl:], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_forward(p: Params, x: Tensor, positions: Tensor, cfg: ArchConfig,
                *, causal: bool = True, group=None,
                seq: bool = False) -> Tensor:
    """Expanded-form MLA for training and prefill: x (B, S, d) -> (B, S,
    d), differentiable.  q and k (B, S, H, nope + rope) and v (B, S, H, v)
    go through ``ops.flash_attention`` in one call (no KV sharing: k's rope
    half is the one latent rope row, copied to every head).  Under TP
    (``group``) over this rank's heads (the module docstring), with
    ``seq`` on S-shards."""
    x = L.tp_enter(x, group, seq)
    dt = x.dtype
    b, s = x.shape[0], x.shape[1]
    nope, rpe, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _queries(p, x, positions, cfg, dt)
    nh = q_nope.shape[2]
    c_kv, k_rope = _latent(p, x, positions, cfg, dt)
    kv = (c_kv @ p["wkv_b"].to(dt)).reshape(b, s, nh, nope + vh)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, nh, rpe)],
                  dim=-1)
    out = ops.flash_attention(q, k, v, causal=causal)
    return L.tp_exit(out.reshape(b, s, nh * vh) @ p["wo"].to(dt), group,
                     seq)


def mla_latent_cache(p: Params, x: Tensor, positions: Tensor,
                     cfg: ArchConfig) -> Tensor:
    """Compressed cache entries (B, S, kv_lora + rope) in x's dtype."""
    c_kv, k_rope = _latent(p, x, positions, cfg, x.dtype)
    return torch.cat([c_kv, k_rope], dim=-1)


def mla_decode(p: Params, x: Tensor, cache: Tensor, pos: Tensor,
               cfg: ArchConfig, *, group=None, cache_group=None
               ) -> tuple[Tensor, Tensor]:
    """Absorbed-form one-token decode.  x: (B, 1, d); cache: (B, S,
    kv_lora + rope) latent rows; pos: (B,).  The new token's latent row is
    written into ``cache`` at ``pos`` IN PLACE (the reference returns an
    updated copy), and (y (B, 1, d), cache) is returned.  The scores and
    the weighted sum run in fp32 over the latent rows: q_nope is absorbed
    through wkv_b's key half into the latent space, the context taken back
    out through its value half.

    Under TP (``group``) this rank's heads' queries are absorbed through
    its ``wkv_b`` key columns, and its heads of the context go out through
    its value columns and its ``wo`` rows, then ``layers.tp_exit``; the
    latent row is whole on every rank (``wkv_a`` replicated).  With
    ``cache_group`` (the group itself) the cache holds this rank's range
    of a sequence split over the group (positions [j S, (j + 1) S) on rank
    j): the rank that holds ``pos`` writes the row, the heads' absorbed
    queries ``[q_lat | q_rope]`` are all-gathered over the group in one
    call, each rank scores every head against its range, and
    ``distributed.merge_softmax`` joins the ranges (one pmax, one psum).
    Without it every rank holds, writes and attends the whole cache for
    its own heads: no gather, no merge."""
    x = L.tp_enter(x, group)
    dt = x.dtype
    b = x.shape[0]
    nope, rpe, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvl = cfg.kv_lora_rank
    q_nope, q_rope = _queries(p, x, pos[:, None], cfg, dt)
    nh = q_nope.shape[2]
    new_entry = mla_latent_cache(p, x, pos[:, None], cfg)  # (B, 1, kvl+rpe)
    s_len = cache.shape[1]
    off = distributed.axis_index(cache_group) * s_len
    bidx = torch.arange(b, device=x.device)
    row = new_entry[:, 0].to(cache.dtype)
    if cache_group is not None:
        # every rank writes its slot; a slot outside its range keeps the
        # value it held
        at = pos - off
        own = ((at >= 0) & (at < s_len))[:, None]
        at = torch.clamp(at, 0, s_len - 1)
        cache[bidx, at] = torch.where(own, row, cache[bidx, at])
    else:
        cache[bidx, pos] = row

    wkv_b = p["wkv_b"].to(dt).reshape(kvl, nh, nope + vh)
    wk = wkv_b[..., :nope].float()  # (kvl, H, nope)
    wv = wkv_b[..., nope:].float()  # (kvl, H, v)
    q_lat = torch.einsum("bqhn,khn->bqhk", q_nope.float(), wk)
    q_rope = q_rope.float()
    if cache_group is not None:
        q_all = distributed.all_gather_tiled(
            torch.cat([q_lat, q_rope], dim=-1), cache_group, dim=2)
        q_lat, q_rope = q_all[..., :kvl], q_all[..., kvl:]
    c_kv = cache[..., :kvl].float()
    k_rope = cache[..., kvl:].float()
    s = (torch.einsum("bqhk,bsk->bhqs", q_lat, c_kv)
         + torch.einsum("bqhr,bsr->bhqs", q_rope, k_rope))
    s = s * (1.0 / math.sqrt(nope + rpe))
    valid = (off + torch.arange(s_len, device=x.device)[None, :]
             <= pos[:, None])
    s = torch.where(valid[:, None, None, :], s, -torch.inf)
    if cache_group is not None:
        m = torch.amax(s, dim=-1)
        e = torch.exp(s - torch.where(torch.isneginf(m), 0.0, m)[..., None])
        ctx_lat = distributed.merge_softmax(
            m, torch.sum(e, dim=-1), torch.einsum("bhqs,bsk->bhqk", e, c_kv),
            cache_group)
        j = distributed.axis_index(cache_group)
        ctx_lat = ctx_lat[:, j * nh:(j + 1) * nh].transpose(1, 2)
    else:
        w = torch.softmax(s, dim=-1)
        ctx_lat = torch.einsum("bhqs,bsk->bqhk", w, c_kv)  # (B, 1, H, kvl)
    out = torch.einsum("bqhk,khv->bqhv", ctx_lat, wv)
    y = out.reshape(b, 1, nh * vh).to(dt) @ p["wo"].to(dt)
    return L.tp_exit(y, group), cache
