"""CUDA kernel wrapper: the fused corrected sampled-softmax loss with
shared negatives (paper eq. 2-3), forward only.

Counterpart of ``repro.kernels.sampled_loss`` (a Pallas kernel); the kernel
is ``csrc/sampled_loss.cu``: bf16 with d a multiple of 8 and 16-byte
aligned rows on the tensor cores, fp32 and other bf16 widths on the CUDA
cores, over a grid of (token tiles, m-splits) whose splits' partials a
second kernel folds in a fixed order.  ``plan`` picks the route, the tiles
and the splits by shape; ``launches`` counts the entry point's calls (one
per call, the fold included)."""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0

_DTYPES = (torch.float32, torch.bfloat16)

#: the tilings the kernel instantiates, by route: (tokens, negatives, e1,
#: e2) per block, with (e1, e2) the warp tile on the tensor cores ("mma")
#: and the register micro-tile's edge, twice, on the CUDA cores ("simt")
TILINGS = {"mma": ((64, 64, 32, 32), (80, 128, 80, 32)),
           "simt": ((32, 64, 4, 4),)}
#: blocks an H100 runs at once, as the plan counts them: one tensor-core
#: block per SM of its 132, two of the small CUDA-core ones
SLOTS = {"mma": 132, "simt": 264}
#: at or under this T * m the plan takes one split: the fold's launch then
#: costs about what the split saves
ONE_SPLIT_WORK = 1 << 14


class Plan(NamedTuple):
    """Blocks of ``bt`` tokens x ``bn`` negatives (``e1``, ``e2`` as in
    TILINGS) on route ``route``: ``n_tt`` token tiles by ``splits`` runs
    of ``per_split`` negative tiles.  ``workspace`` is the (2, splits, T)
    partials' shape where there is more than one split, else (0,)."""
    route: str
    bt: int
    bn: int
    e1: int
    e2: int
    n_tt: int
    splits: int
    per_split: int
    workspace: tuple[int, ...]


def layout(t: int, m: int, route: str, tiling: tuple[int, int, int, int],
           splits: int) -> Plan:
    """The plan of (T = t, m) at ``tiling`` on ``route`` with at most
    ``splits`` m-splits (fewer where a split would be empty).  Raises for
    a tiling the kernel lacks and for a grid it cannot launch."""
    if tiling not in TILINGS.get(route, ()) or splits < 1:
        raise ValueError(f"sampled_loss: no kernel tiling {tiling} on route "
                         f"{route!r} (splits {splits})")
    bt, bn, e1, e2 = tiling
    n_tt, n_nt = -(-t // bt), -(-m // bn)
    per_split = -(-n_nt // splits)
    splits = -(-n_nt // per_split) if n_nt else 1
    if n_tt > 2**31 - 1 or splits > 65535:
        raise ValueError(f"sampled_loss: (T {t}, m {m}) needs a grid of "
                         f"({n_tt}, {splits}) blocks")
    return Plan(route, bt, bn, e1, e2, n_tt, splits, per_split,
                (2, splits, t) if splits > 1 else (0,))


@functools.lru_cache(maxsize=1024)
def plan(t: int, m: int, d: int, dtype: torch.dtype, aligned: bool = True
         ) -> Plan:
    """The kernel's route, tiles and m-splits at (T, m, d, dtype).

    bf16 with d % 8 == 0 and 16-byte aligned h and w_neg (``aligned``)
    takes the tensor cores ("mma"), fp32 and other bf16 widths the CUDA
    cores ("simt").  Of the route's tilings and splits, the plan takes the
    one whose busiest slot does the least work: waves of SLOTS[route]
    blocks times a block's tokens x negatives, fewer blocks on a tie
    (each block reads its h and w_neg tiles: fewer blocks read fewer
    bytes).  At llama3-8b's entry shape (T 2,176, m 512) that is 28 x 4
    blocks of 80 x 128, one wave; at (T 1,024, m 512) fp32 32 x 8 of 32 x
    64.  Where T m is at most ONE_SPLIT_WORK, m is not split."""
    mma = dtype == torch.bfloat16 and d % 8 == 0 and aligned
    route = "mma" if mma else "simt"
    best, best_key = None, None
    for tiling in TILINGS[route]:
        bt, bn = tiling[:2]
        n_tt, n_nt = -(-t // bt), max(1, -(-m // bn))
        for splits in (range(1, n_nt + 1) if t * m > ONE_SPLIT_WORK
                       else (1,)):
            p = layout(t, m, route, tiling, splits)
            if p.splits != splits:
                continue  # the same blocks as a smaller count
            blocks = p.n_tt * p.splits
            key = (-(-blocks // SLOTS[route]) * bt * bn * max(p.per_split, 1),
                   blocks)
            if best_key is None or key < best_key:
                best, best_key = p, key
    return best


def sampled_loss(h: torch.Tensor, w_neg: torch.Tensor, logq: torch.Tensor,
                 pos_logit: torch.Tensor, *, m_total: int) -> torch.Tensor:
    """h: (T, d) and w_neg: (m, d) CUDA, both fp32 or both bf16; logq:
    (m,) and pos_logit: (T,) fp32 -> (T,) fp32 per-example loss
    ``logsumexp([pos, h.w_neg^T - logq - log m_total]) - pos``."""
    global launches
    if h.dtype not in _DTYPES:
        raise TypeError(f"h must be one of {_DTYPES}, got {h.dtype}")
    _build.check("h", h, 2, h.dtype)
    _build.check("w_neg", w_neg, 2, h.dtype)
    _build.check("logq", logq, 1)
    _build.check("pos_logit", pos_logit, 1)
    t, d = h.shape
    m = w_neg.shape[0]
    if w_neg.shape[1] != d or logq.shape[0] != m or pos_logit.shape[0] != t:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, w_neg "
                         f"{tuple(w_neg.shape)}, logq {tuple(logq.shape)}, "
                         f"pos_logit {tuple(pos_logit.shape)}")
    if not (h.device == w_neg.device == logq.device == pos_logit.device):
        raise ValueError("h, w_neg, logq and pos_logit must be on one device")
    if m_total < 1:
        raise ValueError(f"m_total must be >= 1, got {m_total}")
    out = torch.empty((t,), dtype=torch.float32, device=h.device)
    if t == 0:
        return out
    p = plan(t, m, d, h.dtype,
             h.data_ptr() % 16 == 0 and w_neg.data_ptr() % 16 == 0)
    ws = (torch.empty(p.workspace, dtype=torch.float32, device=h.device)
          if p.splits > 1 else None)  # one split: unused
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.launch("sampled_loss", h.data_ptr(), w_neg.data_ptr(),
                  logq.data_ptr(), pos_logit.data_ptr(), out.data_ptr(),
                  0 if ws is None else ws.data_ptr(), t, m, d,
                  math.log(m_total), int(h.dtype == torch.bfloat16),
                  int(p.route == "mma"), p.bt, p.bn, p.e1, p.e2, p.splits,
                  h.device.index, stream)
    launches += 1
    return out
