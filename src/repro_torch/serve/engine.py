"""Serving: the unsharded prefill, decode and top-k steps of
``repro.serve.engine`` (inference never samples the softmax — the paper's
technique is training-only, paper §5.2).

Three head paths: the dense full-head MIPS (``index=None``), the
hierarchy-backed beam retrieval over a ``RetrievalIndex``
(``serve/retrieval.py``) and the two-stage midx beam over a
``QuantizedRetrievalIndex`` (``serve/quantized_index.py``), picked by the
index's type as the reference picks by its treedef.  The step
constructors serve the decoder LMs (``models/transformer.py``: the dense,
moe, ssm and hybrid families) and the encoder-decoder
(``models/encdec.py``): ``make_prefill_step`` runs the prompt through
every layer (attention through the flash kernel, mamba through its
chunked scan, MoE through its capacity dispatch) and picks the first
token, or for the encoder-decoder encodes the frames (the encoder's
self-attention through the flash kernel), projects every decoder layer's
cross K/V into the cache and takes the first decoder step from token 0
at position 0; ``make_decode_step`` takes one greedy step against the
caches (K/V or MLA's latent rows written in place, mamba states
replaced) and ``make_topk_step`` one step with a top-k over the
vocabulary.

On a ``(data, model)`` mesh under the reference's ``ctx_for_serve``
(``sharding/rules.py``: ``tp``, parameters replicated over ``data``, or
tp_fsdp where the config sets ``serve_fsdp``, dbrx-132b and
deepseek-v3-671b, their F leaves gathered over ``data`` per layer) each
rank holds its shards of every parameter (``param_specs_for`` in that
mode: a ``StackedLM`` drawn by ``transformer.init_lm(..., shard=True)``
or carried by ``convert``, an ``EncDec`` carried by ``convert``) and
serves its rows of the batch (``rules.serve_rows``): every family's
backbone runs tensor-parallel over the model group, with
sequence-sharded KV and latent caches, channel-sharded mamba states and
experts dispatched on their model rank (``models/transformer.py``), or
the encoder-decoder's self and cross caches sequence-sharded
(``models/encdec.py``); the head is this rank's vocab shard: the dense
path merges the shards' candidates through ``retrieval.dense_topk``
(``distributed.sharded_logits_topk``, padding rows masked), the index
paths through the sharded ``retrieval.decode_topk`` and
``quantized_index.decode_topk``; the greedy token is the dense path's
k = 1.  ``make_decode_step`` and ``make_topk_step`` take the caches'
whole length there (``max_len``) and, for the encoder-decoder, the
encoder's frames (``frames``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api, encdec, transformer
from repro_torch.serve import quantized_index, retrieval
from repro_torch.sharding import rules


def _decode_step(cfg: ArchConfig, max_len: int | None = None,
                 frames: int | None = None, batch: int | None = None):
    """The family's one-token decoder step, told its caches' whole lengths
    (``transformer.decode_step``'s ``max_len`` and its whole ``batch``;
    ``encdec.decode_step``'s ``max_len`` and ``frames``)."""
    if cfg.family == "encdec":
        return functools.partial(encdec.decode_step, max_len=max_len,
                                 frames=frames)
    return functools.partial(transformer.decode_step, max_len=max_len,
                             batch=batch)


def _require_serve(cfg: ArchConfig, ctx) -> None:
    """Refuse a config whose backbone does not serve on the mesh ``ctx``
    (``api.require_serve_mesh``)."""
    if rules.on_mesh(ctx):
        api.require_serve_mesh(cfg)


def _argmax_island(cfg: ArchConfig, ctx, head, h2d):
    """Greedy next token over the (unsharded) head.

    head: (n, d); h2d: (B, d) -> (B,) int32 argmax ids of the fp32 logits
    ``h @ head^T`` over the true vocab — the k = 1 case of the dense
    ``decode_topk`` path, with its tie-breaking: the lowest class id
    wins (``torch.argmax`` returns the first maximal index).  On a mesh:
    the sharded dense top-k at k = 1."""
    if rules.on_mesh(ctx):
        return decode_topk(cfg, ctx, head, h2d, 1)[0][:, 0]
    logits = h2d.float() @ head.float().T
    if cfg.vocab_size < head.shape[0]:
        logits[:, cfg.vocab_size:] = -torch.inf
    return torch.argmax(logits, dim=-1).to(torch.int32)


#: serving index type -> its top-k decode
_DECODERS = {retrieval.RetrievalIndex: retrieval.decode_topk,
             quantized_index.QuantizedRetrievalIndex:
             quantized_index.decode_topk}


def decode_topk(cfg: ArchConfig, ctx, head, h2d, k: int, *,
                index=None, beam: int | None = None):
    """Top-k (ids, logits) for a batch of hidden states (DESIGN.md §5).

    head: (n, d) head table (dense path only); h2d: (B, d) hidden states ->
    ids (B, k) int32 class ids and logits (B, k) fp32, sorted descending,
    ties to the lowest class id.  With an ``index`` its beam path runs: a
    ``RetrievalIndex``'s hierarchy descent or a ``QuantizedRetrievalIndex``'s
    two stages (exact at full beam, up to row quantization for int8 rows;
    ``beam`` = recall knob).  On a mesh ``head`` is this rank's (v_l, d)
    shard and ``h2d`` its data block."""
    if index is None:
        return retrieval.dense_topk(head, h2d, k, n_valid=cfg.vocab_size,
                                    ctx=ctx)
    decoder = _DECODERS.get(type(index))
    if decoder is None:
        raise NotImplementedError(
            f"{type(index).__name__} is not a serving index of the port "
            f"(only {', '.join(t.__name__ for t in _DECODERS)})")
    return decoder(index, h2d, k, beam, ctx)


def make_decode_fn(cfg: ArchConfig, ctx, head, k: int, *,
                   beam: int | None = None):
    """``decode(index, h (B, d)) -> (ids, logits)`` for the serving engine
    (``serve/server.py``): the index is an argument, so the engine's
    double-buffered swap re-binds it per microbatch.  ``index=None`` serves
    the dense head path."""
    rules.on_mesh(ctx)

    def decode(index, h2d):
        return decode_topk(cfg, ctx, head, h2d, k, index=index, beam=beam)

    return decode


def make_topk_step(cfg: ArchConfig, ctx, k: int, *, index=None,
                   beam: int | None = None, max_len: int | None = None,
                   frames: int | None = None, batch: int | None = None):
    """topk_step(params, token (B, 1), caches, pos (B,)) ->
    (ids (B, k), logits (B, k), caches).

    One decoder step, then top-k over the vocab through the serving index
    (either type; the dense head when ``index`` is None).  ``ids[:, 0]``
    equals ``make_decode_step``'s greedy token when the beam is full (or
    the index absent), ties aside.  ``max_len``, ``frames``, ``batch``:
    ``make_decode_step``'s."""
    _require_serve(cfg, ctx)
    decode_step = _decode_step(cfg, max_len, frames, batch)

    @torch.no_grad()
    def step(params, token, caches, pos):
        h, caches = decode_step(params, token, caches, pos, cfg, ctx)
        head = api.head_table(params, cfg, ctx)
        ids, logits = decode_topk(cfg, ctx, head, h[:, 0, :], k,
                                  index=index, beam=beam)
        return ids, logits, caches

    return step


def make_decode_step(cfg: ArchConfig, ctx, max_len: int | None = None,
                     frames: int | None = None, batch: int | None = None):
    """decode_step(params, token (B, 1), caches, pos (B,)) ->
    (next_token (B,), caches).  ``max_len``: the caches' whole length
    (``make_prefill_step``'s), needed on a mesh where they hold attention
    (``transformer.decode_step``); ``frames``: an encoder-decoder's
    encoder frames, the cross caches' whole length, needed there too
    (``encdec.decode_step``); ``batch``: the whole batch a rank's rows are
    of, needed by a MoE layer in tp mode at dp > 1 where the rows do not
    tell it (``moe.moe_rows``)."""
    _require_serve(cfg, ctx)
    decode_step = _decode_step(cfg, max_len, frames, batch)

    @torch.no_grad()
    def step(params, token, caches, pos):
        h, caches = decode_step(params, token, caches, pos, cfg, ctx)
        head = api.head_table(params, cfg, ctx)
        return _argmax_island(cfg, ctx, head, h[:, 0, :]), caches

    return step


def make_prefill_step(cfg: ArchConfig, ctx, max_len: int,
                      batch: int | None = None):
    """prefill(params, {"tokens": (B, S)}) -> (first generated token (B,),
    caches of length ``max_len``); for the encoder-decoder
    prefill(params, {"frames": (B, Sf, d)}) -> (the token after token 0
    at position 0, the decoder's cache: its self K/V of ``max_len``
    positions and every layer's cross K/V over the Sf frames).  On a mesh
    the batch is this rank's rows (``rules.serve_rows``); ``batch``:
    ``make_decode_step``'s."""
    _require_serve(cfg, ctx)
    whole_batch = batch

    @torch.no_grad()
    def step(params, batch):
        if cfg.family == "encdec":
            frames = batch["frames"]
            b = frames.shape[0]
            enc_out = encdec.encode(params, frames, cfg, ctx)
            # the whole batch these rows are a block of (b x dp), or b
            # itself where they are a whole batch dp does not divide:
            # either gives this rank's cache shapes
            whole = b * ctx.dp if rules.on_mesh(ctx) else b
            caches = encdec.init_dec_cache(params, cfg, whole, max_len,
                                           enc_out, ctx)
            del enc_out
            tok0 = torch.zeros((b, 1), dtype=torch.long,
                               device=frames.device)
            pos0 = torch.zeros((b,), dtype=torch.long, device=frames.device)
            h, caches = encdec.decode_step(params, tok0, caches, pos0, cfg,
                                           ctx, max_len, frames.shape[1])
        else:
            h, caches = transformer.prefill(params, batch["tokens"], cfg,
                                            ctx, max_len=max_len,
                                            batch=whole_batch)
        head = api.head_table(params, cfg, ctx)
        return _argmax_island(cfg, ctx, head, h[:, -1, :]), caches

    return step
