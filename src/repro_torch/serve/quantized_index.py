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
``lax.top_k`` does.

On a ``(data, model)`` mesh (``sharding/rules.py``) the index is
vocab-sharded as the reference's P('model') arrays are: each rank of the
model group builds the lists and int8 rows of its own head rows
(``_build_local``, the shard's true classes its ``n_valid``) and keeps
only that shard, ``perm`` mapping to its LOCAL row ids; ``decode_topk``
runs the shard's beam and merges the shards' k candidates with ONE
all-gather of (T, tp k) ids and logits over the model group.
``convert.index_to_jax`` gathers the shards into the reference's
shard-after-shard layout.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import distributed, midx
from repro_torch.serve.retrieval import dense_topk
from repro_torch.sharding import rules
from repro_torch.utils.misc import top_k

Tensor = torch.Tensor

#: bytes of dequantized rows ``decode_topk`` gathers at once
STAGE2_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class QuantizedRetrievalIndex:
    """Packed quantized serving index; with ``tp > 1`` the tensors hold ONE
    shard's lists: shard ``shard_index`` of ``tp``, built from head rows
    [shard_index v_shard, (shard_index + 1) v_shard) (the sizes below are
    the shard's).

    c1:      (K1, d) fp32 coarse codebook.
    c2:      (K2, d) fp32 residual codebook.
    codes:   (P, 2) int32 codeword pair per posting list.
    cnt:     (P,) fp32 valid rows per list.
    perm:    (P * L,) int32 packed position -> original (local) row id.
    rows:    (P, L, d) member rows: int8 when bits == 8, fp32 when 32.
    scale:   (P, L) fp32 per-row dequantization scales (ones for fp32):
             row ~= rows * scale[..., None].
    n:       true (global) class count.
    tp:      vocab-parallel degree the lists were built for.
    v_shard: embedding rows per shard (global id = shard * v_shard + local
             id).
    bits:    8 or 32, the row payload's width.
    shard_index: the shard these tensors hold (0 when tp == 1).
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
    shard_index: int = 0

    TENSORS = ("c1", "c2", "codes", "cnt", "perm", "rows", "scale")

    @property
    def num_lists_shard(self) -> int:
        return self.rows.shape[0]

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


def _build_local(w: Tensor, n_valid: int, *, codewords: int,
                 codebooks: int, list_size: int | None, bits: int
                 ) -> dict[str, Tensor]:
    """One shard's (or the whole table's) lists and rows: ``midx.build``
    over ``w``'s rows, the first ``n_valid`` of them true classes."""
    s = midx.build(w, codewords=codewords, codebooks=codebooks,
                   list_size=list_size, n_valid=n_valid)
    rows, scale = _quantize_rows(s.wq, bits)
    return dict(c1=s.c1, c2=s.c2, codes=s.codes, cnt=s.cnt, perm=s.perm,
                rows=rows, scale=scale)


@torch.no_grad()
def build_quantized_index(w: Tensor, ctx=None, *, codewords: int = 16,
                          codebooks: int = 2, list_size: int | None = None,
                          bits: int = 8, vocab_size: int | None = None
                          ) -> QuantizedRetrievalIndex:
    """The quantized serving index of a class-embedding table.

    w: (n, d) head table, UNPROJECTED (stage-2 dots are the true logits up
    to row quantization), any float dtype (read as fp32); the index lives
    on w's device.  Built by ``core/midx.build`` (PC bisection into lists,
    two small k-means).  With a mesh ``ctx`` w is this rank's (v_l, d)
    vocab shard (``api.head_table(..., ctx)``), and the index its shard
    (the module docstring)."""
    if bits not in (8, 32):
        raise ValueError(f"bits must be 8 or 32, got {bits}")
    n_rows = w.shape[0]
    knobs = dict(codewords=codewords, codebooks=codebooks,
                 list_size=list_size, bits=bits)
    if not rules.on_mesh(ctx):
        n = vocab_size if vocab_size is not None else n_rows
        return QuantizedRetrievalIndex(**_build_local(w, n, **knobs), n=n,
                                       tp=1, v_shard=n_rows, bits=bits)
    n = vocab_size if vocab_size is not None else n_rows * ctx.tp
    j = ctx.model_index
    return QuantizedRetrievalIndex(
        **_build_local(w, rules.local_n_valid(n, n_rows, j), **knobs), n=n,
        tp=ctx.tp, v_shard=n_rows, bits=bits, shard_index=j)


def _shard_topk(index: QuantizedRetrievalIndex, h: Tensor, k: int,
                beam: int | None) -> tuple[Tensor, Tensor]:
    """The index's own shard's two-stage beam: (GLOBAL ids (T, k) int32,
    logits (T, k)), best first."""
    num_lists, leaf, d = index.rows.shape
    b = num_lists if beam is None else min(beam, num_lists)
    if k > b * leaf:
        raise ValueError(f"k={k} needs beam * list_size >= k, got "
                         f"{b} * {leaf}")
    n_valid = rules.local_n_valid(index.n, index.v_shard, index.shard_index)
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
    dots = torch.where(pos < n_valid, dots, -torch.inf)
    tq = h.shape[0]
    logits, sel = top_k(dots.reshape(tq, b * leaf), k)
    picked = torch.gather(pos.reshape(tq, b * leaf), 1, sel)
    ids = index.perm[picked] + index.shard_index * index.v_shard
    return ids.to(torch.int32), logits


@torch.no_grad()
def decode_topk(index: QuantizedRetrievalIndex, h: Tensor, k: int,
                beam: int | None = None, ctx=None
                ) -> tuple[Tensor, Tensor]:
    """Top-k ids and logits over the vocabulary through the index.

    h: (T, d) -> (ids (T, k) int32 class ids, logits (T, k) fp32 exact
    dequantized dots), sorted descending, ties to the lowest position.
    ``beam``: posting lists re-scored per query and shard (None, or at
    least the list count, is exhaustive: exact up to row quantization).
    On a mesh each rank runs its shard's beam over its rows ``h`` and the
    model group merges the shards' k candidates: ONE all-gather of the
    (T, k) ids and logits packed side by side (the ids' int32 bits in fp32
    lanes), then a top-k.  A sharded index without its mesh raises."""
    if not rules.on_mesh(ctx):
        if index.tp != 1:
            raise ValueError(f"an index sharded over tp={index.tp} decodes "
                             f"on its mesh (ctx)")
        return _shard_topk(index, h, k, beam)
    if (index.tp, index.shard_index) != (ctx.tp, ctx.model_index):
        raise ValueError(f"shard {index.shard_index} of an index packed for "
                         f"tp={index.tp} on model position "
                         f"{ctx.model_index} of tp={ctx.tp}")
    ids, logits = _shard_topk(index, h, k, beam)
    both = torch.stack([logits, ids.view(torch.float32)], dim=-1)
    both = distributed.all_gather_tiled(both, ctx.model_group, dim=1)
    logits, sel = top_k(both[..., 0], k)
    all_ids = both[..., 1].contiguous().view(torch.int32)
    return torch.gather(all_ids, 1, sel), logits


@torch.no_grad()
def recall_at_k(index: QuantizedRetrievalIndex, w: Tensor, h: Tensor,
                k: int, beam: int | None, ctx=None) -> float:
    """|retrieved ∩ dense top-k| / k averaged over queries: the index's
    recall knob, against the fp32 dense top-k of ``w`` (on a mesh this
    rank's head shard, its top-k merged over the model group)."""
    ids, _ = decode_topk(index, h, k, beam, ctx)
    true_ids, _ = dense_topk(w, h, k, n_valid=index.n, ctx=ctx)
    hits = (ids[:, :, None] == true_ids[:, None, :]).any(dim=1)
    return float(torch.mean(torch.sum(hits, dim=-1) / k))
