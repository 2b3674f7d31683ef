"""Serving: the unsharded prefill, decode and top-k steps of
``repro.serve.engine`` (inference never samples the softmax — the paper's
technique is training-only, paper §5.2).

Three head paths: the dense full-head MIPS (``index=None``), the
hierarchy-backed beam retrieval over a ``RetrievalIndex``
(``serve/retrieval.py``) and the two-stage midx beam over a
``QuantizedRetrievalIndex`` (``serve/quantized_index.py``), picked by the
index's type as the reference picks by its treedef.  The step
constructors serve the decoder LMs (``models/transformer.py``: the dense,
moe, ssm and hybrid families): ``make_prefill_step`` runs the prompt
through every layer (attention through the flash kernel, mamba through its
chunked scan, MoE through its capacity dispatch) and picks the first
token, ``make_decode_step`` takes one greedy step against the caches (K/V
or MLA's latent rows written in place, mamba states replaced) and
``make_topk_step`` one step with a top-k over the vocabulary.  The
encoder-decoder family and the mesh path arrive with their slices.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api, transformer
from repro_torch.serve import quantized_index, retrieval


def _require_decoder(cfg: ArchConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(
            "the encoder-decoder family is not ported yet (ROADMAP.md A16)")


def _argmax_island(cfg: ArchConfig, ctx, head, h2d):
    """Greedy next token over the (unsharded) head.

    head: (n, d); h2d: (B, d) -> (B,) int32 argmax ids of the fp32 logits
    ``h @ head^T`` over the true vocab — the k = 1 case of the dense
    ``decode_topk`` path, with its tie-breaking: the lowest class id
    wins (``torch.argmax`` returns the first maximal index)."""
    retrieval.require_unsharded(ctx)
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
    ``beam`` = recall knob)."""
    retrieval.require_unsharded(ctx)
    if index is None:
        return retrieval.dense_topk(head, h2d, k, n_valid=cfg.vocab_size)
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
    retrieval.require_unsharded(ctx)

    def decode(index, h2d):
        return decode_topk(cfg, ctx, head, h2d, k, index=index, beam=beam)

    return decode


def make_topk_step(cfg: ArchConfig, ctx, k: int, *, index=None,
                   beam: int | None = None):
    """topk_step(params, token (B, 1), caches, pos (B,)) ->
    (ids (B, k), logits (B, k), caches).

    One decoder step, then top-k over the vocab through the serving index
    (either type; the dense head when ``index`` is None).  ``ids[:, 0]``
    equals ``make_decode_step``'s greedy token when the beam is full (or
    the index absent), ties aside."""
    _require_decoder(cfg)
    retrieval.require_unsharded(ctx)

    @torch.no_grad()
    def step(params, token, caches, pos):
        h, caches = transformer.decode_step(params, token, caches, pos, cfg,
                                            ctx)
        head = api.head_table(params, cfg)
        ids, logits = decode_topk(cfg, ctx, head, h[:, 0, :], k,
                                  index=index, beam=beam)
        return ids, logits, caches

    return step


def make_decode_step(cfg: ArchConfig, ctx):
    """decode_step(params, token (B, 1), caches, pos (B,)) ->
    (next_token (B,), caches)."""
    _require_decoder(cfg)
    retrieval.require_unsharded(ctx)

    @torch.no_grad()
    def step(params, token, caches, pos):
        h, caches = transformer.decode_step(params, token, caches, pos, cfg,
                                            ctx)
        head = api.head_table(params, cfg)
        return _argmax_island(cfg, ctx, head, h[:, 0, :]), caches

    return step


def make_prefill_step(cfg: ArchConfig, ctx, max_len: int):
    """prefill(params, {"tokens": (B, S)}) -> (first generated token (B,),
    caches of length ``max_len``)."""
    _require_decoder(cfg)
    retrieval.require_unsharded(ctx)

    @torch.no_grad()
    def step(params, batch):
        h, caches = transformer.prefill(params, batch["tokens"], cfg, ctx,
                                        max_len=max_len)
        head = api.head_table(params, cfg)
        return _argmax_island(cfg, ctx, head, h[:, -1, :]), caches

    return step
