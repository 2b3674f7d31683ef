"""Serving decode — the unsharded top-k head of ``repro.serve.engine``.

Two head paths: the dense full-head MIPS (``index=None``) and the
hierarchy-backed beam retrieval over a ``RetrievalIndex``
(``serve/retrieval.py``).  The quantized (midx) index, the mesh path and
the transformer decode steps arrive with their slices.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.serve import retrieval


def decode_topk(cfg: ArchConfig, ctx, head, h2d, k: int, *,
                index: retrieval.RetrievalIndex | None = None,
                beam: int | None = None):
    """Top-k (ids, logits) for a batch of hidden states (DESIGN.md §5).

    head: (n, d) head table (dense path only); h2d: (B, d) hidden states ->
    ids (B, k) int32 class ids and logits (B, k) fp32, sorted descending,
    ties to the lowest class id.  With an ``index`` the beam retrieval path
    runs (exact at full beam, ``beam`` = recall knob)."""
    retrieval.require_unsharded(ctx)
    if index is None:
        return retrieval.dense_topk(head, h2d, k, n_valid=cfg.vocab_size)
    if not isinstance(index, retrieval.RetrievalIndex):
        raise NotImplementedError(
            f"{type(index).__name__} is not ported yet; only the fp32 "
            "RetrievalIndex serves")
    return retrieval.decode_topk(index, h2d, k, beam, ctx)


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
