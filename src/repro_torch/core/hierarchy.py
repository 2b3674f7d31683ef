"""Hierarchical Gram statistics — the Gram/heap half of
``repro.core.hierarchy`` (DESIGN.md §2.1, §2.5).

A hierarchy of class sets whose per-node statistic is the Gram sum
``Z_C = sum_{j in C} w_j w_j^T`` plus a true-class count and the max
squared row norm ``ub(C)``; the serving index (``serve/retrieval.py``)
prunes with them.  The leaf Grams go through ``ops.zstats`` (the CUDA kernel
on the card), which computes the same function as the reference's einsum.

``descend``, ``leaf_logits``, ``update_rows`` and the feature (rff) half
arrive with the training slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.utils.misc import log2_int, next_pow2

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class HierarchyStats:
    """Per-level Gram statistics + the (possibly projected) sampling table.

    levels_z:   tuple over levels root..leaf of (nodes_l, r, r) fp32 Gram
                sums; level l of a full binary tree holds 2^l nodes, and the
                two-level form holds only the leaf level.
    levels_cnt: tuple over levels of (nodes_l,) fp32 true (non-padding)
                counts |C|.
    levels_ub:  tuple over levels of (nodes_l,) fp32 max squared row norms
                ``max_{j in C} ||w_j||^2``.
    wq:         (num_leaves, leaf_size, r) fp32 copy of the class embeddings
                (projected if a projection was given; zero rows for padding
                and for rows at/after ``n_valid``).
    n_valid:    0-dim int32 tensor on ``wq``'s device — number of real
                classes.
    n:          row-count bound (the table size at build time).
    """

    levels_z: tuple[Tensor, ...]
    levels_cnt: tuple[Tensor, ...]
    levels_ub: tuple[Tensor, ...]
    wq: Tensor
    n_valid: Tensor
    n: int

    @property
    def depth(self) -> int:
        return len(self.levels_z) - 1

    @property
    def num_leaves(self) -> int:
        return self.wq.shape[0]

    @property
    def leaf_size(self) -> int:
        return self.wq.shape[1]

    @property
    def n_pad(self) -> int:
        return self.num_leaves * self.leaf_size


def _n_valid_tensor(n_valid, device: torch.device) -> Tensor:
    return torch.as_tensor(n_valid, dtype=torch.int32, device=device)


def project(w: Tensor, proj: Tensor | None) -> Tensor:
    """fp32 copy of ``w``, optionally moved to the rank-r sampling space."""
    w32 = w.float()
    if proj is None:
        return w32
    return w32 @ proj.float().T


def leaf_counts(n_valid: Tensor, num_leaves: int, leaf_size: int) -> Tensor:
    """True (non-padding) class count of each leaf block.

    n_valid: 0-dim int tensor -> (num_leaves,) fp32 counts."""
    starts = torch.arange(num_leaves, dtype=torch.float32,
                          device=n_valid.device) * leaf_size
    return torch.clamp(n_valid.float() - starts, 0.0, float(leaf_size))


def leaf_ub(wq: Tensor) -> Tensor:
    """Max squared row norm of each leaf block: wq (L, B, r) -> (L,) fp32."""
    return torch.amax(torch.sum(wq * wq, dim=-1), dim=-1)


def ub_levels_from_wq(wq: Tensor, depth: int) -> tuple[Tensor, ...]:
    """Rebuild the per-level max-norm statistic bottom-up from ``wq``."""
    levels = [leaf_ub(wq)]
    for _ in range(depth):
        child = levels[0]
        levels.insert(0, torch.maximum(child[0::2], child[1::2]))
    return tuple(levels)


def build(w: Tensor, leaf_size: int, *, proj: Tensor | None = None,
          n_valid: Tensor | int | None = None,
          full_tree: bool = True) -> HierarchyStats:
    """Build the hierarchy bottom-up: leaf Gram blocks, then pairwise sums.

    w: (n, d) class embeddings.  ``full_tree=True`` rounds the leaf count to
    a power of two and builds every binary level up to the root;
    ``full_tree=False`` keeps only the leaf level.  ``n_valid``: number of
    real classes (rows beyond it carry no mass).  Level tuples are ordered
    root..leaf."""
    n_rows, _ = w.shape
    if n_valid is None:
        n_valid = n_rows
    n_valid = _n_valid_tensor(n_valid, w.device)
    wq = project(w, proj)
    r = wq.shape[-1]
    if full_tree:
        leaf_size = next_pow2(leaf_size)
        num_leaves = next_pow2(max(1, -(-n_rows // leaf_size)))
    else:
        num_leaves = -(-n_rows // leaf_size)
    pad = num_leaves * leaf_size - n_rows
    wq = torch.nn.functional.pad(wq, (0, 0, 0, pad))
    # Zero any rows at/after n_valid (pads must carry no mass).
    row_ok = torch.arange(num_leaves * leaf_size, device=w.device) < n_valid
    wq = torch.where(row_ok[:, None], wq, 0.0)
    wq = wq.reshape(num_leaves, leaf_size, r)

    z = ops.zstats(wq)  # (num_leaves, r, r)
    cnt = leaf_counts(n_valid, num_leaves, leaf_size)

    levels_z = [z]
    levels_cnt = [cnt]
    levels_ub = [leaf_ub(wq)]
    if full_tree:
        while levels_z[0].shape[0] > 1:
            child_z = levels_z[0]
            child_c = levels_cnt[0]
            child_u = levels_ub[0]
            levels_z.insert(0, child_z[0::2] + child_z[1::2])
            levels_cnt.insert(0, child_c[0::2] + child_c[1::2])
            levels_ub.insert(0, torch.maximum(child_u[0::2], child_u[1::2]))
    return HierarchyStats(tuple(levels_z), tuple(levels_cnt),
                          tuple(levels_ub), wq, n_valid, n_rows)


# --- flat heap packing (DESIGN.md §2.5) --------------------------------------


def heap_rows(num_leaves: int) -> int:
    """Rows of the packed heap: 2^(d+1)-1 nodes padded to an even 2*L."""
    return 2 * num_leaves


def pack_levels(levels) -> Tensor:
    """Heap-pack a root..leaf tuple of per-level tensors into one tensor.

    Level l occupies rows [2^l - 1, 2^(l+1) - 1); one zero padding row
    rounds the total to an even 2L — the layout ``RetrievalIndex`` carries."""
    first = levels[0]
    pad = torch.zeros((1, *first.shape[1:]), dtype=first.dtype,
                      device=first.device)
    return torch.cat(list(levels) + [pad], dim=0)


def unpack_levels(heap: Tensor, depth: int) -> tuple[Tensor, ...]:
    """Inverse of ``pack_levels``: contiguous row slices back to
    root..leaf."""
    out, off = [], 0
    for lvl in range(depth + 1):
        size = 1 << lvl
        out.append(heap[off:off + size])
        off += size
    return tuple(out)


def to_heap(stats: HierarchyStats) -> tuple[Tensor, Tensor]:
    """Pack levels root..leaf into flat (2L, r, r) / (2L,) tensors.  The
    max-norm bound is not packed — ``from_heap`` rebuilds it from ``wq``."""
    return pack_levels(stats.levels_z), pack_levels(stats.levels_cnt)


def from_heap(z_heap: Tensor, cnt_heap: Tensor, wq: Tensor, n_valid,
              n: int | None = None) -> HierarchyStats:
    """Inverse of ``to_heap``: row slices back into per-level tuples, with
    the max-norm bound rebuilt from ``wq``."""
    num_leaves = wq.shape[0]
    depth = log2_int(num_leaves)
    if z_heap.shape[0] != heap_rows(num_leaves):
        raise ValueError(f"heap of {z_heap.shape[0]} rows does not fit "
                         f"{num_leaves} leaves")
    if n is None:
        n = num_leaves * wq.shape[1]
    return HierarchyStats(unpack_levels(z_heap, depth),
                          unpack_levels(cnt_heap, depth),
                          ub_levels_from_wq(wq, depth), wq,
                          _n_valid_tensor(n_valid, wq.device), n)
