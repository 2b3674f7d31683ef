"""CUDA kernel wrappers: the midx sampler's two scoring stages.

``midx_pair_masses``: stage-1 list masses ``cnt[p] * (alpha * <h[t],
ct[p]>^2 + 1)`` against the pair-expanded codewords ``ct``;
``midx_list_masses``: the same kernel forming ``ct[p] = c1[codes[p, 0]] +
c2[codes[p, 1]]`` itself; ``midx_member_scores``: stage-2 scores ``alpha *
<rows[g, l], h[g]>^2 + 1`` over each draw's gathered posting list.
Counterparts of ``repro.kernels.midx_scores`` (Pallas kernels); the kernels
are ``csrc/midx_scores.cu`` (stage 1 tiled by ``plan``, stage 2 over
``csrc/row_dots.cuh`` with ``leaf_scores.plan``'s chunks).
``pair_launches`` counts the stage-1 kernel's launches through either
entry, ``member_launches`` stage 2's."""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.leaf_scores import plan as member_plan

pair_launches = 0
member_launches = 0

#: queries and lists per stage-1 block (midx_scores.cu's kTq and kTp)
QUERIES = 32
LISTS = 32
_GRID_Y_MAX = 65535
_TYPES = (torch.float32, torch.bfloat16)


class Plan(NamedTuple):
    """Stage-1 blocks of QUERIES x LISTS outputs, ``grid_t`` x ``grid_p``
    of them (the launch's grid y and x); each loops over the width."""
    grid_t: int
    grid_p: int


@functools.lru_cache(maxsize=1024)
def plan(t: int, p: int) -> Plan:
    """The stage-1 grid over a (T, P) output.  Raises where its y would
    pass 65,535 blocks."""
    grid_t = -(-t // QUERIES)
    if grid_t > _GRID_Y_MAX:
        raise ValueError(f"midx_pair_masses: T {t} needs {grid_t} query "
                         f"tiles, over {_GRID_Y_MAX}")
    return Plan(grid_t, -(-p // LISTS))


def _check_values(h: torch.Tensor, tables: dict[str, torch.Tensor],
                  cnt: torch.Tensor) -> None:
    """Types and shapes, before any device check: h fp32 or bf16, the
    codeword tables of h's type and width, cnt fp32."""
    if h.dtype not in _TYPES:
        raise TypeError(f"h must be fp32 or bf16, got {h.dtype}")
    for name, x in tables.items():
        if x.dtype != h.dtype:
            raise TypeError(f"{name} must be of h's type {h.dtype}, got "
                            f"{x.dtype}")
        if x.dim() != 2 or x.shape[1] != h.shape[-1]:
            raise ValueError(f"shape mismatch: h {tuple(h.shape)}, {name} "
                             f"{tuple(x.shape)}")
    if cnt.dtype != torch.float32:
        raise TypeError(f"cnt must be fp32, got {cnt.dtype}")


def _launch(name: str, h: torch.Tensor, tables: list[torch.Tensor],
            codes: list[torch.Tensor], cnt: torch.Tensor,
            alpha: float) -> torch.Tensor:
    global pair_launches
    _build.check("h", h, 2, h.dtype)
    for x in tables:
        _build.check("codewords", x, 2, h.dtype)
    _build.check("cnt", cnt, 1)
    t, d = h.shape
    p = cnt.shape[0]
    if len({x.device for x in (h, cnt, *tables, *codes)}) != 1:
        raise ValueError("h, the codewords, codes and cnt must be on one "
                         "device")
    out = torch.empty((t, p), dtype=torch.float32, device=h.device)
    if out.numel() == 0:
        return out
    pl = plan(t, p)
    elem = h.element_size()
    vec = d % (16 // elem) == 0 and all(
        x.data_ptr() % 16 == 0 for x in (h, *tables))
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.launch(name, h.data_ptr(), *(x.data_ptr() for x in tables),
                  *(x.data_ptr() for x in codes), cnt.data_ptr(),
                  out.data_ptr(), t, p, d, float(alpha), elem, int(vec),
                  pl.grid_t, pl.grid_p, h.device.index, stream)
    pair_launches += 1
    return out


def midx_pair_masses(h: torch.Tensor, ct: torch.Tensor, cnt: torch.Tensor,
                     *, alpha: float = 100.0) -> torch.Tensor:
    """h: (T, d); ct: (P, d) of h's type (fp32 or bf16); cnt: (P,) fp32;
    CUDA -> (T, P) fp32 masses."""
    _check_values(h, {"ct": ct}, cnt)
    if ct.shape[0] != cnt.shape[0]:
        raise ValueError(f"shape mismatch: ct {tuple(ct.shape)}, cnt "
                         f"{tuple(cnt.shape)}")
    return _launch("midx_pair_masses", h, [ct], [], cnt, alpha)


def midx_list_masses(h: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                     codes: torch.Tensor, cnt: torch.Tensor, *,
                     alpha: float = 100.0) -> torch.Tensor:
    """h: (T, d); c1: (K1, d), c2: (K2, d) of h's type (fp32 or bf16);
    codes: (P, 2) int32 into c1 and c2; cnt: (P,) fp32; CUDA -> (T, P) fp32
    masses against ``c1[codes[:, 0]] + c2[codes[:, 1]]``, formed in the
    kernel.  The codes are not range-checked: they come from
    ``core.midx.build``."""
    _check_values(h, {"c1": c1, "c2": c2}, cnt)
    if codes.dim() != 2 or codes.shape != (cnt.shape[0], 2):
        raise ValueError(f"shape mismatch: codes {tuple(codes.shape)}, cnt "
                         f"{tuple(cnt.shape)}")
    _build.check("codes", codes, 2, torch.int32)
    return _launch("midx_list_masses", h, [c1, c2], [codes], cnt, alpha)


def midx_member_scores(h: torch.Tensor, rows: torch.Tensor, *,
                       alpha: float = 100.0) -> torch.Tensor:
    """h: (G, d); rows: (G, L, d) fp32 CUDA -> (G, L) fp32 scores."""
    global member_launches
    _build.check("h", h, 2)
    _build.check("rows", rows, 3)
    g, d = h.shape
    if rows.shape[0] != g or rows.shape[2] != d:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, rows "
                         f"{tuple(rows.shape)}")
    if h.device != rows.device:
        raise ValueError("h and rows must be on one device")
    n_list = rows.shape[1]
    out = torch.empty((g, n_list), dtype=torch.float32, device=h.device)
    if out.numel() == 0:
        return out
    p = member_plan(g, n_list, d)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.launch("midx_member_scores", h.data_ptr(), rows.data_ptr(),
                  out.data_ptr(), g, n_list, d, float(alpha), p.chunk,
                  p.unroll, h.device.index, stream)
    member_launches += 1
    return out
