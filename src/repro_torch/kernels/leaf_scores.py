"""CUDA kernel wrapper: per-draw within-leaf scores.

``square=True``: ``alpha * (rows[g, b] . h[g])^2 + 1`` (quadratic kernel);
``square=False``: raw dots ``rows[g, b] . h[g]`` (alpha ignored).
Counterpart of ``repro.kernels.leaf_scores`` (a Pallas kernel); the kernel
is ``csrc/leaf_scores.cu`` over ``csrc/row_dots.cuh``, one block per (g,
chunk of rows) as ``plan`` picks them (``midx_member_scores`` shares the
body and the plan).  ``launches`` counts the kernel's launches."""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0

#: warps per block, and 16-byte loads each lane keeps in flight
#: (row_dots.cuh's kRowWarps and kLoads)
ROW_WARPS = 8
LOADS = 8
#: blocks the plan aims at before it splits a g's rows: ~4 per SM of an
#: H100's 132
TARGET_BLOCKS = 528
_INT_MAX = 2**31 - 1


class Plan(NamedTuple):
    """Blocks of ``chunk`` rows of one g, ``n_chunks`` per g, ``grid`` in
    all on a 1-D grid; each lane loads ``unroll`` float4 of each of
    LOADS / unroll rows per step."""
    chunk: int
    unroll: int
    n_chunks: int
    grid: int


@functools.lru_cache(maxsize=1024)
def plan(g: int, b: int, r: int) -> Plan:
    """The kernel's blocks at (G, B, r).  unroll is LOADS from r = 1,024
    on (a lane's eight float4 of one row; llama3-8b's r = 4,096) and 1
    below (one float4 of each of eight rows; the samplers' r = 128), the
    kernel's two variants.  A g's rows are split into chunks, whole warp
    passes each, while the grid has fewer than TARGET_BLOCKS blocks
    (llama3-8b's full beam: 128 g of 4,096 rows).  Raises when the grid
    would pass 2^31 - 1 blocks."""
    unroll = LOADS if r >= 1024 else 1
    per_pass = ROW_WARPS * (LOADS // unroll)  # rows a block takes per pass
    n_chunks = 1
    if g < TARGET_BLOCKS:
        n_chunks = min(-(-TARGET_BLOCKS // g), -(-b // per_pass))
    rows = -(-b // n_chunks)
    chunk = -(-rows // per_pass) * per_pass
    n_chunks = -(-b // chunk)
    if g * n_chunks > _INT_MAX:
        raise ValueError(f"leaf_scores: (G {g}, B {b}) needs "
                         f"{g * n_chunks} blocks, over 2^31 - 1")
    return Plan(chunk, unroll, n_chunks, g * n_chunks)


def leaf_scores(h: torch.Tensor, rows: torch.Tensor, *, alpha: float = 100.0,
                square: bool = True) -> torch.Tensor:
    """h: (G, r); rows: (G, B, r) fp32 CUDA -> (G, B) fp32 scores."""
    global launches
    _build.check("h", h, 2)
    _build.check("rows", rows, 3)
    g, r = h.shape
    if rows.shape[0] != g or rows.shape[2] != r:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, rows "
                         f"{tuple(rows.shape)}")
    if h.device != rows.device:
        raise ValueError("h and rows must be on one device")
    b = rows.shape[1]
    out = torch.empty((g, b), dtype=torch.float32, device=h.device)
    if out.numel() == 0:
        return out
    p = plan(g, b, r)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.launch("leaf_scores", h.data_ptr(), rows.data_ptr(),
                  out.data_ptr(), g, b, r, float(alpha), int(square),
                  p.chunk, p.unroll, h.device.index, stream)
    launches += 1
    return out
