"""CUDA kernel wrappers: the fused sampled-softmax head.

``fused_lse``: per-token ``logsumexp_k(f(<h_t, w[ids[t,k]]> + biasg[t,k]) -
corr[t,k])`` with f the identity or ``|.|`` (``abs_mode``); ``fused_lse_bwd``:
its VJP.  Counterparts of ``repro.kernels.fused_head`` (Pallas kernels); the
kernels are ``csrc/fused_head.cu``.  ``fwd_launches`` and ``bwd_launches``
count the entry points' calls (the backward's entry runs three kernels and
counts once).

``w`` and ``h`` are fp32 or bf16 (one dtype for both), read as they are and
computed in fp32; every output is fp32.  ``ids`` are int32 on the card:
``ops.fused_head_lse`` converts the port's int64 ids once, at this
boundary.  Ids are not range-checked here (that would cost a device sync
per call): rows outside ``w`` are a caller error.

dL/dw is deterministic: row i is the fp32 sum ``acc = acc + dcoef[s] *
h[t(s)]`` (each product and sum rounded) over the slots s = t*K + k with
``ids[s] == i``, in ascending s, as the Pallas kernel's sequential grid adds
them.  The slots of each list tile (``plan(...).q`` tiles of ``TILE_ROWS``
rows) are cut into runs of ``plan(...).run`` in ascending s; a list of one
run (every list at uniform ids) gives exactly that sum, a longer list's
runs are summed each from 0 and added in run order.  Rows no slot names
are written 0: dw is not zero-filled first.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

#: running-max start of the online logsumexp (as the Pallas scratch init)
NEG_INF = -1e30
#: corr value that forces a slot's mass to exactly zero (masked / padded)
MASK_CORR = 1e30

fwd_launches = 0
bwd_launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2**31 - 1

#: slots a warp takes per pass: one 16-byte (fp32) or 8-byte (bf16) load of
#: each of GROUP rows in flight per lane (csrc kGroup)
GROUP = 8
#: warps per token block, at most (csrc kMaxWarps, its __launch_bounds__):
#: K = 129 takes 17, one pass each
MAX_WARPS = 20
#: warps of the backward's first launch, at least: its sort blocks share
#: the token blocks' size
SORT_WARPS = 8
#: shared memory the backward's per-warp dh strips may take
DH_SMEM = 96 * 1024
#: shared memory the sort blocks' per-warp counts (one per list) may take
SORT_SMEM = 160 * 1024
#: lists at most: the sort blocks zero and scan, and the scan kernel sums,
#: counts per list, so fewer lists are cheaper; the dw blocks of a list's
#: q tiles each read the whole list
MAX_LISTS = 512
#: slots a sort block takes, least; sort blocks at most (the scan kernel
#: reads chunks x lists counts per block)
MIN_CHUNK, MAX_CHUNKS = 2048, 256
#: columns a lane group covers per pass: 32 lanes x 4 (csrc kColChunk)
COL_CHUNK = 128
#: rows of dL/dw one block of the dw pass owns (csrc kTileRows)
TILE_ROWS = 64
#: slots of a list one dw block sums, least (a power of two); runs of a
#: list, at most (csrc kMaxRuns: the fold stages their masks)
MIN_RUN, MAX_RUNS = 256, 512
#: device memory the split lists' partial rows may take
PARTIAL_BYTES = 64 * 1024 * 1024


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


class Plan(NamedTuple):
    """The fused head's launches at (T, K, d, n).

    ``fwd_warps``: warps per token block of the forward.  ``warps``: the
    same for the backward's first launch, T token blocks and
    ``n_chunks`` sort blocks of ``chunk`` slots that rank each slot in
    its list tile's list (``q`` tiles of TILE_ROWS rows; ``n_lists`` of
    them); the scan kernel places them.  The dw pass: a (units,
    col_chunks) grid, a block per run of a list (each list cut into runs
    of at most ``run`` slots; units an upper bound of the runs) that
    writes the list's ``q`` of the ``n_tiles`` tiles; ``partials`` run
    slots for split lists; ``workspace`` int32 words in all."""
    warps: int
    fwd_warps: int
    chunk: int
    n_chunks: int
    q: int
    n_lists: int
    n_tiles: int
    run: int
    col_chunks: int
    units: int
    partials: int
    workspace: int


def workspace_parts(s: int, d: int, n_chunks: int, q: int, n_lists: int,
                    n_tiles: int, run: int, partials: int, col_chunks: int
                    ) -> dict[str, int]:
    """int32 words of each workspace segment, in the kernel's order; the
    partial rows start 16-byte aligned (csrc ``carve``)."""
    parts = dict(cnt=n_lists * -(-n_chunks // 4) * 4,
                 unit=4 * (n_lists + -(-s // run)), lp=s, lrt=s, rk=s,
                 etot=n_lists, toff=n_lists, nsb=n_lists + 1,
                 done=n_tiles * col_chunks,
                 pmask=partials * q * col_chunks * 2)
    parts["pad"] = -sum(parts.values()) % 4
    parts["partial"] = partials * q * TILE_ROWS * d
    return parts


@functools.lru_cache(maxsize=1024)
def plan(t: int, k: int, d: int, n: int) -> Plan:
    """The launches at T tokens of K slots, width d, n rows of w.

    Token blocks: one per token, ceil(K / GROUP) warps up to MAX_WARPS
    (K = 129: 17 warps of GROUP slots, one pass), so that each lane keeps
    GROUP row loads in flight before it reduces any; the backward's block
    also holds a dh strip per warp (DH_SMEM caps the warps at wide d) and
    runs SORT_WARPS at least.  Sort chunks: MIN_CHUNK slots, doubled
    until there are at most MAX_CHUNKS.  Lists: one per q tiles, q the
    least power of two that gives at most MAX_LISTS lists whose counts
    (warps x lists) fit SORT_SMEM (100,000 rows: q = 4, 391 lists).
    Runs: MIN_RUN, or the power of two that keeps a list to MAX_RUNS runs
    and the split lists' partial rows under PARTIAL_BYTES.  Raises for
    T K past 2^31 - 1 and for a grid past it."""
    s = t * k
    if s > _INT_MAX:
        raise ValueError(f"fused_head: T {t} x K {k} = {s} slots, past "
                         f"2^31 - 1")
    if t < 1 or k < 1 or d < 1 or n < 1:
        raise ValueError(f"fused_head: empty shape (T {t}, K {k}, d {d}, "
                         f"n {n})")
    col_chunks = -(-d // COL_CHUNK)
    fwd_warps = min(MAX_WARPS, -(-k // GROUP))
    strip = col_chunks * COL_CHUNK * 4  # one warp's dh strip, bytes
    warps = min(max(fwd_warps, SORT_WARPS), max(1, DH_SMEM // strip))
    chunk = MIN_CHUNK
    while -(-s // chunk) > MAX_CHUNKS:
        chunk *= 2
    n_chunks = -(-s // chunk)
    n_tiles = -(-n // TILE_ROWS)
    q = 1
    while (-(-n_tiles // q) > MAX_LISTS
           or warps * -(-n_tiles // q) * 4 > SORT_SMEM):
        q *= 2
    n_lists = -(-n_tiles // q)
    run = max(MIN_RUN, _pow2_at_least(-(-s // MAX_RUNS)), _pow2_at_least(
        -(-2 * s * q * TILE_ROWS * d * 4 // PARTIAL_BYTES)))
    units = n_lists + -(-s // run)
    partials = -(-2 * s // run) + 1
    if units > _INT_MAX or t * q * TILE_ROWS > _INT_MAX:
        raise ValueError(f"fused_head: (T {t}, K {k}, n {n}) needs a dw "
                         f"grid of {units} blocks, past 2^31 - 1")
    words = sum(workspace_parts(s, d, n_chunks, q, n_lists, n_tiles, run,
                                partials, col_chunks).values())
    return Plan(warps, fwd_warps, chunk, n_chunks, q, n_lists, n_tiles, run,
                col_chunks, units, partials, words)


def _check(w: Tensor, h: Tensor, ids: Tensor, corr: Tensor,
           biasg: Tensor) -> tuple[int, int, int]:
    if w.dtype not in _DTYPES:
        raise TypeError(f"w must be one of {_DTYPES}, got {w.dtype}")
    _build.check("w", w, 2, w.dtype)
    _build.check("h", h, 2, w.dtype)
    _build.check("ids", ids, 2, torch.int32)
    _build.check("corr", corr, 2)
    _build.check("biasg", biasg, 2)
    t, d = h.shape
    k = ids.shape[1]
    if (w.shape[1] != d or ids.shape[0] != t or corr.shape != ids.shape
            or biasg.shape != ids.shape):
        raise ValueError(f"shape mismatch: w {tuple(w.shape)}, h "
                         f"{tuple(h.shape)}, ids {tuple(ids.shape)}, corr "
                         f"{tuple(corr.shape)}, biasg {tuple(biasg.shape)}")
    if k == 0:
        raise ValueError("ids must hold at least one slot per token")
    if len({x.device for x in (w, h, ids, corr, biasg)}) != 1:
        raise ValueError("w, h, ids, corr and biasg must be on one device")
    return t, k, d


def fused_lse(w: Tensor, h: Tensor, ids: Tensor, corr: Tensor,
              biasg: Tensor, *, abs_mode: bool = False) -> Tensor:
    """w: (n, d); h: (T, d) (both fp32 or both bf16); ids (int32) / corr /
    biasg (fp32): (T, K), CUDA -> (T,) fp32 per-token corrected
    logsumexp."""
    global fwd_launches
    t, k, d = _check(w, h, ids, corr, biasg)
    lse = torch.empty((t,), dtype=torch.float32, device=h.device)
    if t == 0:
        return lse
    p = plan(t, k, d, w.shape[0])
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.launch("fused_lse", w.data_ptr(), h.data_ptr(), ids.data_ptr(),
                  corr.data_ptr(), biasg.data_ptr(), lse.data_ptr(), t, k, d,
                  int(abs_mode), int(w.dtype == torch.bfloat16), p.fwd_warps,
                  h.device.index, stream)
    fwd_launches += 1
    return lse


def fused_lse_bwd(w: Tensor, h: Tensor, ids: Tensor, corr: Tensor,
                  biasg: Tensor, lse: Tensor, gbar: Tensor, *,
                  abs_mode: bool = False
                  ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """VJP of ``fused_lse`` wrt (w, h, biasg, corr).

    lse: (T,) forward output; gbar: (T,) upstream cotangent.  Returns
    (dw (n, d), dh (T, d), dcoef (T, K), dcorr (T, K)) fp32: dcoef is the
    sign-chained per-slot softmax weight (the biasg cotangent), dcorr minus
    the unsigned weight (corr applies after the abs transform).  dw is
    dense, every row written once by the kernel (module docstring); one
    int32 workspace of ``plan(...).workspace`` words per call."""
    global bwd_launches
    t, k, d = _check(w, h, ids, corr, biasg)
    _build.check("lse", lse, 1)
    _build.check("gbar", gbar, 1)
    if lse.shape[0] != t or gbar.shape[0] != t:
        raise ValueError(f"lse {tuple(lse.shape)} and gbar "
                         f"{tuple(gbar.shape)} must be ({t},)")
    dev = h.device
    n = w.shape[0]
    if t == 0:  # no slots: nothing to launch, and dL/dw is all zeros
        return (torch.zeros((n, d), dtype=torch.float32, device=dev),
                torch.empty((0, d), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.float32, device=dev))
    p = plan(t, k, d, n)
    dw = torch.empty((n, d), dtype=torch.float32, device=dev)
    dh = torch.empty((t, d), dtype=torch.float32, device=dev)
    dcoef = torch.empty((t, k), dtype=torch.float32, device=dev)
    dcorr = torch.empty((t, k), dtype=torch.float32, device=dev)
    ws = torch.empty((p.workspace,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.launch("fused_lse_bwd", w.data_ptr(), h.data_ptr(),
                  ids.data_ptr(), corr.data_ptr(), biasg.data_ptr(),
                  lse.data_ptr(), gbar.data_ptr(), dw.data_ptr(),
                  dh.data_ptr(), dcoef.data_ptr(), dcorr.data_ptr(),
                  ws.data_ptr(), t, k, d, n, int(abs_mode),
                  int(w.dtype == torch.bfloat16), p.warps, p.chunk, p.q,
                  p.run, p.workspace, dev.index, stream)
    bwd_launches += 1
    return dw, dh, dcoef, dcorr
