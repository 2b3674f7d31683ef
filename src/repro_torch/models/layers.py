"""Model primitives of the port (``repro.models.layers``): init, norms,
embeddings, RoPE, GQA attention and the MLP.

Conventions, as in the reference:
  * params are nested dicts of tensors; init functions return them;
  * compute dtype = cfg.dtype; storage dtype = cfg.param_dtype; norms,
    softmax statistics and logits in fp32;
  * the reference's ``ShardCtx`` activation constraints have no
    counterpart: a mesh rank holds its own tensors.  Under Megatron TP
    (``tp_fsdp``; ``sharding.rules.tp_group``) the attention and the MLP
    take ``group``, the model group, and this rank's column-parallel
    ``wq/wk/wv/w_gate/w_up`` (and ``bq/bk/bv``) and row-parallel
    ``wo/w_down`` slices: the input enters through
    ``distributed.replicated`` (Megatron's f: its cotangent summed over
    the group), the output leaves through ``distributed.psum`` (g), and
    ``bo``/``b_down`` are added after it.  The attention then runs over
    this rank's heads.  ``apply_embed`` with ``group`` is the
    vocab-parallel lookup of a V-sharded table.  ``group=None``: one
    device's computation.  With ``seq`` (``sharding.rules.seq_sharded``:
    the residual stream's sequence over the model group, Megatron's
    sequence parallelism) x arrives as this rank's (B, S / tp, d) rows:
    the input enters through ``distributed.all_gather_tiled`` over S
    (its backward a reduce-scatter of the heads' partial cotangents), the
    row-parallel output leaves through ``reduce_scatter_tiled`` over S,
    and the embedding's lookup is reduce-scattered over S in place of its
    psum (``tp_enter`` / ``tp_exit``).  ``attn_decode`` under TP serves
    the reference's sequence-sharded KV cache: the step's heads gathered
    over the group (``gather_heads``), each rank's range attended, the
    ranges' softmax merged (``distributed.merge_softmax``); with whole
    weights over such a cache it serves the encoder-decoder's cross
    attention (every head on every rank, the ranges merged).

Full-sequence attention (``attn_forward``) goes through
``kernels.ops.flash_attention``: the CUDA kernel for CUDA tensors (with its
backward kernel under autograd), its plain version for CPU tensors; both
are differentiable, so ``attn_forward`` trains.  ``chunked_attention``
keeps the reference's name and signature for that plain version
(``ref.flash_attention_ref``, which also takes hv != hd and a query
offset).  Learned positions (``init_pos_embed``) and the cross
attention's K/V over an encoder's states (``cross_kv``) serve the
encoder-decoder family (``models/encdec.py``); MLA is ``models/mla.py``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import distributed
from repro_torch.kernels import ops, ref

Tensor = torch.Tensor
Params = dict

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _pdtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               device: torch.device, scale: float | None = None
               ) -> torch.Tensor:
    """Normal init with std ``scale`` (default ``1/sqrt(fan_in)``), drawn
    from ``gen`` on the generator's own device, then placed on ``device``.

    The numbers differ from ``jax.random``'s for the same seed: parity
    tests carry weights across with ``convert.params_from_jax``.  On the
    ``meta`` device nothing is drawn (``gen`` may be None)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * scale
    return x.to(device=device, dtype=dtype)


# --- norms -------------------------------------------------------------------


def init_norm(cfg: ArchConfig, device: torch.device,
              dim: int | None = None) -> Params:
    dim = dim or cfg.d_model
    p = {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=torch.float32, device=device)
    return p


def apply_norm(p: Params, x: Tensor, cfg: ArchConfig) -> Tensor:
    """RMSNorm (eps 1e-6) or LayerNorm (eps 1e-5), computed in fp32 and
    cast back to x's dtype."""
    x32 = x.float()
    if cfg.norm == "layernorm" and "bias" in p:
        mean = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
        out = (x32 - mean) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:
        ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(ms + 1e-6) * p["scale"]
    return out.to(x.dtype)


def rms_norm_only(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    x32 = x.float()
    ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# --- embeddings / positions --------------------------------------------------


def init_embed(gen: torch.Generator, cfg: ArchConfig,
               device: torch.device) -> Params:
    return {"table": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                _pdtype(cfg), device, scale=0.02)}


def tp_enter(x: Tensor, group, seq: bool = False) -> Tensor:
    """A tensor-parallel block's input: Megatron's f
    (``distributed.replicated``), or with ``seq`` this rank's S-shard
    all-gathered over S."""
    if seq:
        return distributed.all_gather_tiled(x, group, dim=1)
    return distributed.replicated(x, group)


def tp_exit(y: Tensor, group, seq: bool = False) -> Tensor:
    """A row-parallel output's partial sums over ``group``: Megatron's g
    (``distributed.psum``), or with ``seq`` their sum reduce-scattered
    over S (this rank's S-shard of it)."""
    if seq:
        return distributed.reduce_scatter_tiled(y, group, dim=1)
    return distributed.psum(y, group)


def embed_rows(table: Tensor, ids: Tensor, group=None,
               dtype: torch.dtype | None = None, seq: bool = False
               ) -> Tensor:
    """``table[ids]`` (cast to ``dtype`` where given).  With ``group``,
    ``table`` is this rank's vocab shard: ids outside it give zero rows,
    and the psum over the group gives each id its owner's row (the
    gradient reaches the owner's rows only); with ``seq`` the sum is
    reduce-scattered over S (``tp_exit``)."""
    if group is None:
        rows = table[ids]
        return rows if dtype is None else rows.to(dtype)
    n_l = table.shape[0]
    off = distributed.axis_index(group) * n_l
    own = (ids >= off) & (ids < off + n_l)
    rows = table[torch.clamp(ids - off, 0, n_l - 1)]
    if dtype is not None:
        rows = rows.to(dtype)
    return tp_exit(torch.where(own[..., None], rows, 0.0), group, seq)


def apply_embed(p: Params, ids: Tensor, cfg: ArchConfig,
                group=None, seq: bool = False) -> Tensor:
    """Rows of the table, cast to the compute dtype (gathered first, then
    cast: the same values as the reference's cast-then-gather); with
    ``group`` a vocab shard's (``embed_rows``)."""
    return embed_rows(p["table"], ids, group, _dtype(cfg), seq)


def init_pos_embed(gen: torch.Generator, cfg: ArchConfig, max_pos: int,
                   device: torch.device) -> Params:
    """A learned position table of ``max_pos`` rows (whisper's), drawn as
    the embedding is (std 0.02)."""
    return {"table": dense_init(gen, (max_pos, cfg.d_model), _pdtype(cfg),
                                device, scale=0.02)}


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, hd); positions: (..., S).  Rotates the two HALVES of
    hd against each other (not interleaved pairs), as the reference."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., :, None].float() * freqs  # (.., S, half)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- attention (GQA) ---------------------------------------------------------


def padded_heads(cfg: ArchConfig, tp: int = 1) -> tuple[int, int]:
    """Head counts padded up to TP divisibility (zero-weight heads); at
    tp = 1 the true counts."""
    def up(h):
        return max(tp, ((h + tp - 1) // tp) * tp)
    nh = up(cfg.n_heads)
    nkv = up(cfg.n_kv_heads) if cfg.n_kv_heads else nh
    while nh % nkv:  # q heads per kv group must stay integral
        nkv += tp
    return nh, nkv


def init_attention(gen: torch.Generator, cfg: ArchConfig,
                   device: torch.device, tp: int = 1,
                   d_model: int | None = None) -> Params:
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    nh, nkv = padded_heads(cfg, tp)
    pd = _pdtype(cfg)
    p = {
        "wq": dense_init(gen, (d, nh * hd), pd, device),
        "wk": dense_init(gen, (d, nkv * hd), pd, device),
        "wv": dense_init(gen, (d, nkv * hd), pd, device),
        "wo": dense_init(gen, (nh * hd, d), pd, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", nh), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros((width * hd,), dtype=pd, device=device)
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones((hd,), dtype=torch.float32,
                                           device=device)}
        p["k_norm"] = {"scale": torch.ones((hd,), dtype=torch.float32,
                                           device=device)}
    return p


def _qkv(p: Params, x: Tensor, cfg: ArchConfig, positions: Tensor,
         rope_on: bool = True) -> tuple[Tensor, Tensor, Tensor]:
    """x: (B, S, d) -> q (B, S, H, hd), k and v (B, S, KV, hd)."""
    dt = _dtype(cfg)
    hd = cfg.resolved_head_dim
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    b, s = x.shape[0], x.shape[1]
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = rms_norm_only(q, p["q_norm"]["scale"])
        k = rms_norm_only(k, p["k_norm"]["scale"])
    if rope_on and cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                      chunk: int, q_offset: int = 0) -> Tensor:
    """The reference's online-softmax attention over KV chunks: q (B, Sq,
    H, hd), k (B, Sk, KV, hd), v (B, Sk, KV, hv), query i at position
    ``q_offset + i``.  One plain version serves both this and the flash
    kernel: ``ref.flash_attention_ref``."""
    return ref.flash_attention_ref(q, k, v, causal=causal, chunk=chunk,
                                   q_offset=q_offset)


def _row_parallel_out(y: Tensor, p: Params, bias: str, cfg: ArchConfig,
                      group, seq: bool = False) -> Tensor:
    """A row-parallel projection's partial sums over ``group``
    (``tp_exit``), then its replicated bias, where the layer has one."""
    y = tp_exit(y, group, seq)
    if bias in p:
        y = y + p[bias].to(_dtype(cfg))
    return y


def attn_prefill(p: Params, x: Tensor, positions: Tensor, cfg: ArchConfig,
                 *, causal: bool = True, group=None, seq: bool = False
                 ) -> tuple[Tensor, Tensor, Tensor]:
    """Full-sequence self-attention through ``ops.flash_attention``.
    x: (B, S, d) -> (y (B, S, d), k and v (B, S, KV, hd) for a cache);
    under TP (``group``) over this rank's heads, k and v its own; with
    ``seq`` x and y are this rank's S-shards (positions stay the whole
    sequence's)."""
    x = tp_enter(x, group, seq)
    q, k, v = _qkv(p, x, cfg, positions, rope_on=not cfg.learned_pos)
    out = ops.flash_attention(q, k, v, causal=causal)
    b, s = x.shape[0], x.shape[1]
    y = out.reshape(b, s, -1) @ p["wo"].to(_dtype(cfg))
    return _row_parallel_out(y, p, "bo", cfg, group, seq), k, v


def attn_forward(p: Params, x: Tensor, positions: Tensor, cfg: ArchConfig,
                 *, causal: bool = True, group=None,
                 seq: bool = False) -> Tensor:
    """Full-sequence self-attention.  x: (B, S, d) -> (B, S, d);
    differentiable in x and every parameter of ``p``."""
    return attn_prefill(p, x, positions, cfg, causal=causal,
                        group=group, seq=seq)[0]


def cross_kv(p: Params, enc: Tensor, cfg: ArchConfig
             ) -> tuple[Tensor, Tensor]:
    """K and V of a cross attention from an encoder's states: enc (B, Sk,
    d) -> (B, Sk, KV, hd) each, no RoPE and no bias, as the reference
    projects them."""
    dt = _dtype(cfg)
    hd = cfg.resolved_head_dim
    b, s = enc.shape[0], enc.shape[1]
    k = (enc @ p["wk"].to(dt)).reshape(b, s, -1, hd)
    v = (enc @ p["wv"].to(dt)).reshape(b, s, -1, hd)
    return k, v


def gather_heads(parts: list[Tensor], group) -> list[Tensor]:
    """Tensors of (B, S, heads_i, hd) over this rank's heads, each with
    every rank's heads in head order, in ONE all-gather over ``group``
    (their heads packed side by side, gathered, then unpacked); the
    tensors themselves off a group."""
    if group is None:
        return parts
    b, s, hd = parts[0].shape[0], parts[0].shape[1], parts[0].shape[-1]
    widths = [t.shape[2] for t in parts]
    packed = torch.cat([t.reshape(b, s, -1, hd) for t in parts], dim=2)
    n = distributed.axis_size(group)
    whole = distributed.all_gather_tiled(packed, group, dim=2).reshape(
        b, s, n, sum(widths), hd)
    out, at = [], 0
    for w in widths:
        out.append(whole[:, :, :, at:at + w].reshape(b, s, n * w, hd))
        at += w
    return out


def attn_decode(p: Params, x: Tensor, cache_k: Tensor, cache_v: Tensor,
                pos: Tensor, cfg: ArchConfig, *, update_cache: bool = True,
                rope_on: bool = True, group=None, cache_group=None
                ) -> tuple[Tensor, Tensor, Tensor]:
    """One-token decode against a KV cache.

    x: (B, 1, d); cache_k/v: (B, S, KV, hd); pos: (B,) current positions.
    Returns (y, cache_k, cache_v).  With ``update_cache`` the new token's
    K/V are written into the caches IN PLACE (the reference returns
    updated copies; writing in place saves a copy of the cache per layer
    and step), and the same tensors are returned.

    Under TP (``group``) the reference's semantics over a cache of every
    KV head: this rank's q / k / v heads are all-gathered over the group
    in one call, and after the attention this rank's heads of the output
    go through its ``wo`` rows and leave through ``tp_exit``.  With
    ``cache_group`` the cache holds this rank's range of a sequence split
    over that group (positions [j S, (j + 1) S) on its rank j): the rank
    that holds ``pos`` writes the new K/V, each rank attends its range for
    every head and ``distributed.merge_softmax`` joins the ranges (else
    the cache is whole and so attended).  ``cache_group`` without
    ``group`` is an attention of whole (replicated) weights over a
    sequence-sharded cache, the encoder-decoder's cross attention: every
    head's q from the whole ``wq``, the ranges merged, the whole ``wo``,
    no gather and no ``tp_exit``."""
    dt = _dtype(cfg)
    hd = cfg.resolved_head_dim
    b = x.shape[0]
    x = tp_enter(x, group)
    q = (x @ p["wq"].to(dt)).reshape(b, 1, -1, hd)
    k = (x @ p["wk"].to(dt)).reshape(b, 1, -1, hd)
    v = (x @ p["wv"].to(dt)).reshape(b, 1, -1, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt).reshape(1, 1, *q.shape[2:])
        k = k + p["bk"].to(dt).reshape(1, 1, *k.shape[2:])
        v = v + p["bv"].to(dt).reshape(1, 1, *v.shape[2:])
    if cfg.qk_norm:
        q = rms_norm_only(q, p["q_norm"]["scale"])
        k = rms_norm_only(k, p["k_norm"]["scale"])
    if rope_on and not cfg.learned_pos and cfg.rope_theta > 0:
        q = rope(q, pos[:, None], cfg.rope_theta)
        k = rope(k, pos[:, None], cfg.rope_theta)
    h_own = q.shape[2]
    q, k, v = gather_heads([q, k, v], group)
    sharded = cache_group is not None
    s_len = cache_k.shape[1]
    off = distributed.axis_index(cache_group) * s_len

    if update_cache:
        # the cache may hold fewer KV heads than a TP-padded projection
        nkv_c = cache_k.shape[2]
        bidx = torch.arange(b, device=x.device)
        if sharded:
            # every rank writes its slot; a slot outside its range keeps
            # the value it held
            at = pos - off
            own = ((at >= 0) & (at < s_len))[:, None, None]
            at = torch.clamp(at, 0, s_len - 1)
            cache_k[bidx, at] = torch.where(
                own, k[:, 0, :nkv_c].to(cache_k.dtype), cache_k[bidx, at])
            cache_v[bidx, at] = torch.where(
                own, v[:, 0, :nkv_c].to(cache_v.dtype), cache_v[bidx, at])
        else:
            cache_k[bidx, pos] = k[:, 0, :nkv_c].to(cache_k.dtype)
            cache_v[bidx, pos] = v[:, 0, :nkv_c].to(cache_v.dtype)

    kv = cache_k.shape[2]
    h = q.shape[2]
    qf = q.float().reshape(b, kv, h // kv, hd) / math.sqrt(hd)
    s = torch.einsum("bkgh,bskh->bkgs", qf, cache_k.float())
    valid = (off + torch.arange(s_len, device=x.device)[None, :]
             <= pos[:, None])
    s = torch.where(valid[:, None, None, :], s, -torch.inf)
    if sharded:
        m = torch.amax(s, dim=-1)
        e = torch.exp(s - torch.where(torch.isneginf(m), 0.0, m)[..., None])
        o = distributed.merge_softmax(
            m, torch.sum(e, dim=-1),
            torch.einsum("bkgs,bskh->bkgh", e, cache_v.float()),
            cache_group)
    else:
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgs,bskh->bkgh", w, cache_v.float())
    o = o.reshape(b, 1, h * hd)
    if group is not None:
        j = distributed.axis_index(group)
        o = o[..., j * h_own * hd:(j + 1) * h_own * hd]
    y = o.to(dt) @ p["wo"].to(dt)
    return _row_parallel_out(y, p, "bo", cfg, group), cache_k, cache_v


# --- MLP ----------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ArchConfig, device: torch.device,
             d_ff: int | None = None, d_model: int | None = None) -> Params:
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    pd = _pdtype(cfg)
    p = {"w_up": dense_init(gen, (d, f), pd, device),
         "w_down": dense_init(gen, (f, d), pd, device)}
    if cfg.act == "silu":
        p["w_gate"] = dense_init(gen, (d, f), pd, device)
    return p


def apply_mlp(p: Params, x: Tensor, cfg: ArchConfig, group=None,
              seq: bool = False) -> Tensor:
    """SwiGLU (with ``w_gate``) or a plain MLP with the TANH-approximated
    gelu, which is ``jax.nn.gelu``'s default; under TP (``group``) over
    this rank's d_ff columns, with ``seq`` on S-shards."""
    dt = _dtype(cfg)
    x = tp_enter(x, group, seq)
    up = x @ p["w_up"].to(dt)
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"].to(dt)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return _row_parallel_out(h @ p["w_down"].to(dt), p, "b_down", cfg,
                             group, seq)
