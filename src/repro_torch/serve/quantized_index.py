"""Quantized serving-side retrieval index, unsharded port of
``repro.serve.quantized_index`` (DESIGN.md §2.9 + §5).

The two-level midx structure the ``"midx"`` sampler carries
(``core/midx.py``), exported as a standalone serving index: the class table
as P balanced posting lists, each quantized to a codeword PAIR over the
c1 x c2 codebook cross-product, plus the packed member rows for exact
re-scoring.  ``decode_topk`` is a two-stage beam search:

  stage 1   rank every posting list by the quantized MIPS surrogate
            t_j = <h, c1[a1_j] + c2[a2_j]> (two (K, d) products and a
            gather: the RAW dot, not the sampling kernel; decode wants the
            largest logit, not kernel mass) and keep the top ``beam``.
  stage 2   re-score the survivors' members exactly with dequantized rows
            and take the flat top-k.

``bits=8`` stores the member rows int8 with per-row absmax scales, about a
quarter of the fp32 ``RetrievalIndex``'s payload (the member table
dominates both); ``bits=32`` keeps fp32 rows (exact at full beam).  No
kernel: the reference's two stages are plain jnp
(``quantized_index.py:164-186`` there), and here plain tensor ops.  Every
top-k breaks ties by the lowest index (``utils.misc.top_k``), as
``lax.top_k`` does.  The mesh (vocab-sharded) forms arrive with the
multi-device slice: a ``ctx`` with a mesh raises (ROADMAP.md A17).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import midx
from repro_torch.serve.retrieval import dense_topk, require_unsharded
from repro_torch.utils.misc import top_k

Tensor = torch.Tensor

#: bytes of dequantized rows ``decode_topk`` gathers at once
STAGE2_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class QuantizedRetrievalIndex:
    """Packed quantized serving index (unsharded: ``tp == 1``).

    c1:      (K1, d) fp32 coarse codebook.
    c2:      (K2, d) fp32 residual codebook.
    codes:   (P, 2) int32 codeword pair per posting list.
    cnt:     (P,) fp32 valid rows per list.
    perm:    (P * L,) int32 packed position -> original row id.
    rows:    (P, L, d) member rows: int8 when bits == 8, fp32 when 32.
    scale:   (P, L) fp32 per-row dequantization scales (ones for fp32):
             row ~= rows * scale[..., None].
    n:       true class count.
    tp:      vocab-parallel degree (1 here).
    v_shard: embedding rows per shard.
    bits:    8 or 32, the row payload's width.
    """

    c1: Tensor
    c2: Tensor
    codes: Tensor
    cnt: Tensor
    perm: Tensor
    rows: Tensor
    scale: Tensor
    n: int
    tp: int
    v_shard: int
    bits: int

    TENSORS = ("c1", "c2", "codes", "cnt", "perm", "rows", "scale")

    @property
    def num_lists_shard(self) -> int:
        return self.rows.shape[0] // self.tp

    @property
    def list_size(self) -> int:
        return self.rows.shape[1]


def payload_bytes(index) -> int:
    """Serialized size of an index, the bytes the train -> serve seam ships
    per swap (the engine's ``index_payload_bytes`` gauge): the sum over its
    ``TENSORS``, for this index (int8 rows: about a quarter of the fp32
    index's bytes) and for the fp32 ``RetrievalIndex`` alike."""
    return int(sum(getattr(index, f).numel() * getattr(index, f).element_size()
                   for f in index.TENSORS))


def _quantize_rows(rows: Tensor, bits: int) -> tuple[Tensor, Tensor]:
    """(P, L, d) fp32 -> (rows', (P, L) scales).  int8: symmetric per-row
    absmax, rounded half to even (``torch.round``, as ``jnp.round``);
    fp32: the rows as they are with unit scales (one path downstream)."""
    if bits == 32:
        return rows, torch.ones(rows.shape[:2], dtype=torch.float32,
                                device=rows.device)
    amax = torch.amax(torch.abs(rows), dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(rows / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequant(rows: Tensor, scale: Tensor) -> Tensor:
    return rows.float() * scale[..., None]


def build_quantized_index(w: Tensor, ctx=None, *, codewords: int = 16,
                          codebooks: int = 2, list_size: int | None = None,
                          bits: int = 8, vocab_size: int | None = None
                          ) -> QuantizedRetrievalIndex:
    """The quantized serving index of a class-embedding table.

    w: (n, d) head table, UNPROJECTED (stage-2 dots are the true logits up
    to row quantization), any float dtype (read as fp32); the index lives
    on w's device.  Built by ``core/midx.build`` (PC bisection into lists,
    two small k-means)."""
    require_unsharded(ctx)
    if bits not in (8, 32):
        raise ValueError(f"bits must be 8 or 32, got {bits}")
    n_rows = w.shape[0]
    n = vocab_size if vocab_size is not None else n_rows
    s = midx.build(w, codewords=codewords, codebooks=codebooks,
                   list_size=list_size, n_valid=n)
    rows, scale = _quantize_rows(s.wq, bits)
    return QuantizedRetrievalIndex(c1=s.c1, c2=s.c2, codes=s.codes,
                                   cnt=s.cnt, perm=s.perm, rows=rows,
                                   scale=scale, n=n, tp=1, v_shard=n_rows,
                                   bits=bits)


def decode_topk(index: QuantizedRetrievalIndex, h: Tensor, k: int,
                beam: int | None = None, ctx=None
                ) -> tuple[Tensor, Tensor]:
    """Top-k ids and logits over the vocabulary through the index.

    h: (T, d) -> (ids (T, k) int32 class ids, logits (T, k) fp32 exact
    dequantized dots), sorted descending, ties to the lowest position.
    ``beam``: posting lists re-scored per query (None, or at least the list
    count, is exhaustive: exact up to row quantization)."""
    require_unsharded(ctx)
    num_lists, leaf, d = index.rows.shape
    b = num_lists if beam is None else min(beam, num_lists)
    if k > b * leaf:
        raise ValueError(f"k={k} needs beam * list_size >= k, got "
                         f"{b} * {leaf}")
    h32 = h.float()
    # stage 1: the quantized MIPS surrogate over the codeword-pair grid
    t = ((h32 @ index.c1.T)[:, index.codes[:, 0].long()]
         + (h32 @ index.c2.T)[:, index.codes[:, 1].long()])
    t = torch.where(index.cnt[None, :] > 0, t, -torch.inf)
    _, lists = top_k(t, b)                                    # (T, B)
    # stage 2: exact re-scoring of the survivors' members, a few queries
    # at a time: one query's dequantized (B, L, d) gather at full beam is
    # 0.8 GB at starcoder2-3b's head
    per_query = b * leaf * d * 4
    chunk = max(1, STAGE2_BYTES // per_query)
    dots = torch.cat([
        torch.einsum("tbld,td->tbl",
                     _dequant(index.rows[lists[i:i + chunk]],
                              index.scale[lists[i:i + chunk]]),
                     h32[i:i + chunk])
        for i in range(0, h.shape[0], chunk)])
    pos = lists[..., None] * leaf + torch.arange(leaf, device=h.device)
    dots = torch.where(pos < index.n, dots, -torch.inf)
    tq = h.shape[0]
    logits, sel = top_k(dots.reshape(tq, b * leaf), k)
    picked = torch.gather(pos.reshape(tq, b * leaf), 1, sel)
    return index.perm[picked].to(torch.int32), logits


def recall_at_k(index: QuantizedRetrievalIndex, w: Tensor, h: Tensor,
                k: int, beam: int | None, ctx=None) -> float:
    """|retrieved ∩ dense top-k| / k averaged over queries: the index's
    recall knob, against the fp32 dense top-k of ``w``."""
    ids, _ = decode_topk(index, h, k, beam, ctx)
    true_ids, _ = dense_topk(w, h, k, n_valid=index.n)
    hits = (ids[:, :, None] == true_ids[:, None, :]).any(dim=1)
    return float(torch.mean(torch.sum(hits, dim=-1) / k))
