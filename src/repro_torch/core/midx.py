"""Balanced PC-bisection — the part of ``repro.core.midx`` the serving index
uses.  The midx sampler and its posting lists arrive with their slice."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def pc_bisect_perm(w: Tensor, n_valid: Tensor | int, depth: int,
                   iters: int = 8) -> Tensor:
    """Balanced PC-bisection co-clustering permutation.

    w: (n_pad, d) with n_pad = 2^depth * leaf_size.  Level by level, each
    node's rows are sorted by their projection onto the node's top principal
    direction (a few power iterations on the uncentered second moment) and
    split in half.  Rows at/after ``n_valid`` sort with key +inf, so padding
    stays a contiguous suffix; the sort is STABLE, as ``jnp.argsort`` is, so
    the padding suffix keeps its order.  Returns (n_pad,) int32: packed
    position -> original row."""
    n_pad, d = w.shape
    w32 = w.float()
    perm = torch.arange(n_pad, dtype=torch.int64, device=w.device)
    for lvl in range(depth):
        nb = 1 << lvl
        bs = n_pad >> lvl
        blocks = w32[perm].reshape(nb, bs, d)
        v = torch.sum(blocks, dim=1)
        v = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-9)
        for _ in range(iters):
            u = torch.einsum("nbd,nd->nb", blocks, v)
            v = torch.einsum("nbd,nb->nd", blocks, u)
            v = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-9)
        key = torch.einsum("nbd,nd->nb", blocks, v)
        key = torch.where(perm.reshape(nb, bs) < n_valid, key, torch.inf)
        order = torch.sort(key, dim=1, stable=True).indices
        perm = torch.gather(perm.reshape(nb, bs), 1, order).reshape(-1)
    return perm.to(torch.int32)
