"""CUDA kernel wrapper: batched quadratic forms
``out[t, n] = alpha * h_t^T Z_n h_t + cnt_n``.

Counterpart of ``repro.kernels.block_scores`` (a Pallas kernel); the kernel
is ``csrc/block_scores.cu``: register-tiled fp32 over units of (node, tile
of Z_n, query tile), run by as many blocks as stay resident on the card,
and a second kernel that sums the tiles' partials in a fixed order where a
node has more than one tile.  ``plan`` picks the tiling by shape;
``launches`` counts the entry point's calls (one per call, both kernels
included)."""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0

#: rows of Z per staged chunk in the kernel: row tiles are a multiple of it
CHUNK_ROWS = 32
#: the (queries, columns, micro-tile edge) tilings the kernel instantiates,
#: by T: the byte-bound T <= 16 and the operations-bound T > 16
TILINGS = ((16, 128, 4), (64, 128, 8))
#: units the plan aims at before it splits Z_n's rows: ~2 per SM of an
#: H100's 132
TARGET_UNITS = 264
_INT_MAX = 2**31 - 1


class Plan(NamedTuple):
    """A tiling of the (T, N) output into ``units`` of work, each ``tq``
    queries x one (``bi`` x ``bj``) tile of Z_n with an ``m`` x ``m``
    micro-tile per thread: ``n_qt`` query tiles and ``n_i`` x ``n_j``
    tiles per node.  ``workspace`` is the (N, T, tiles) partials' shape
    where a node has more than one tile, else (0,)."""
    tq: int
    bj: int
    m: int
    bi: int
    n_qt: int
    n_i: int
    n_j: int
    units: int
    workspace: tuple[int, ...]


def layout(t: int, n: int, r: int, tq: int, bj: int, m: int, bi: int
           ) -> Plan:
    """The plan of (T = t, N = n, r) at query tile ``tq``, column tile
    ``bj``, micro-tile ``m`` and row tile ``bi``.  Raises for a tiling the
    kernel lacks and for more than 2^31 - 1 units (or combine threads)."""
    if (tq, bj, m) not in TILINGS or bi <= 0:
        raise ValueError(f"block_scores: no kernel tiling (tq {tq}, bj {bj},"
                         f" m {m}, bi {bi})")
    n_qt, n_i, n_j = -(-t // tq), -(-r // bi), -(-r // bj)
    tiles = n_i * n_j
    units = n * n_qt * tiles
    if units > _INT_MAX or (tiles > 1 and n * t * 32 > _INT_MAX):
        raise ValueError(f"block_scores: (T {t}, N {n}, r {r}) needs "
                         f"{units} units, over 2^31 - 1")
    return Plan(tq, bj, m, bi, n_qt, n_i, n_j, units,
                (n, t, tiles) if tiles > 1 else (0,))


@functools.lru_cache(maxsize=1024)
def plan(t: int, n: int, r: int) -> Plan:
    """The kernel's tiling at (T, N, r), the faster of the tilings timed on
    an H100 (PERF.md, PR 17).

    At T > 16 the work is bound by operations (T / 2 FLOP per byte of Z):
    64 queries x 128 columns with 8 x 8 micro-tiles (4 shared loads feed
    64 FMAs; 4 x 4 ones at 32 queries were slower on the training root
    and the tree's levels).  At T <= 16 it is bound by bytes: 16 queries x
    128 columns, 4 x 4.  Then Z_n's rows are split, in halves of whole
    chunks, while there are fewer than TARGET_UNITS units: the 8 nodes at
    r = 4,096 and the few nodes of a tree's or index's top levels still
    fill the card (serving's nine levels ran faster split than whole)."""
    tq, bj, m = (16, 128, 4) if t <= 16 else (64, 128, 8)
    per_rows = n * -(-t // tq) * -(-r // bj)  # units per row tile
    rows = -(-r // CHUNK_ROWS) * CHUNK_ROWS
    while per_rows * -(-r // rows) < TARGET_UNITS and rows // 2 >= CHUNK_ROWS:
        rows = -(-(rows // 2) // CHUNK_ROWS) * CHUNK_ROWS
    return layout(t, n, r, tq, bj, m, rows)


def block_scores(h: torch.Tensor, z: torch.Tensor, cnt: torch.Tensor, *,
                 alpha: float = 100.0) -> torch.Tensor:
    """h: (T, r); z: (N, r, r); cnt: (N,) fp32 CUDA -> (T, N) fp32."""
    global launches
    _build.check("h", h, 2)
    _build.check("z", z, 3)
    _build.check("cnt", cnt, 1)
    t, r = h.shape
    n = z.shape[0]
    if z.shape[1:] != (r, r) or cnt.shape[0] != n:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, z "
                         f"{tuple(z.shape)}, cnt {tuple(cnt.shape)}")
    if not (h.device == z.device == cnt.device):
        raise ValueError("h, z and cnt must be on one device")
    out = torch.empty((t, n), dtype=torch.float32, device=h.device)
    if out.numel() == 0:
        return out
    p = plan(t, n, r)
    ws = (torch.empty(p.workspace, dtype=torch.float32, device=h.device)
          if p.workspace != (0,) else None)  # one tile per node: unused
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.launch("block_scores", h.data_ptr(), z.data_ptr(), cnt.data_ptr(),
                  out.data_ptr(), 0 if ws is None else ws.data_ptr(), t, n, r,
                  float(alpha), p.tq, p.bj, p.m, p.bi, h.device.index, stream)
    launches += 1
    return out
