"""CUDA kernel wrappers: causal (or full) online-softmax GQA attention,
forward (``flash_attention``, optionally with its log-sum-exp) and
backward (``flash_attention_bwd``, whose tensor-core grid ``plan``
picks).

Counterpart of ``repro.kernels.flash_attention`` (a Pallas kernel, forward
only; the reference differentiates its pure-jnp ``chunked_attention``);
the kernels are in ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``.  They take the reference's
``chunked_attention`` layout directly, q (B, Sq, H, hd), k (B, Sk, KV, hd)
and v (B, Sk, KV, hv), with a value width hv that may differ from the q/k
width hd (MLA's expanded form: hd 192, hv 128) and a key length Sk that
may differ from the query length Sq (an encoder-decoder's cross
attention, not causal: whisper's text tokens over its audio frames; a
causal call needs Sk = Sq), and read (and the backward writes) KV head
``h // (H // KV)`` in place at its own length, so neither the
reference's repeated-KV copy, its head-major transposes nor any padding
of k and v to Sq exist here.

Two routes each way, picked by dtype and widths (``uses_tensor_cores``):
bf16 with hd and hv multiples of 16, hd up to 192 and hv up to 128, goes
to the tensor-core kernels (counted in ``launches`` and ``bwd_launches``),
everything else (fp32, other widths up to 256 each) to the CUDA-core
kernels (``flash_attention_simt``, counted in ``simt_launches`` and
``bwd_simt_launches``).  Each backward's two kernels sit behind one entry
point and count as one launch.

The tensor-core backward (wgmma with TMA, warp-specialised: one producer
warp keeps a 3-stage ring of tile copies in flight behind mbarriers, two
consumer warpgroups of 64 rows take the registers ``setmaxnreg`` gives
them).  Its dQ kernel holds 128 queries a block and sweeps the 64-key
tiles they see twice: the first sums D = rowsum(P o dP) from the fp32 P
and dP (D from the forward's bf16 output, even with its bf16 remainder,
keeps dQ 20-30x further off the exact chain rule:
``tools/flash_bwd_delta_error.py``), the second forms S = Q K^T and dP =
dO V^T from shared memory, then dQ += dS K with dS as two bf16 halves
from the registers.  Its dK/dV kernel holds 128 keys a block and sweeps
(query head, 64-query tile) steps: S^T = K Q^T, dP^T = V dO^T, then dV +=
P^T dO and dK += dS^T Q with P^T and dS^T as bf16 halves.  At (192, 128)
its block holds 64 keys (``key_tile``), one consumer summing dK and the
other dV, where one consumer holding both would spill.  A KV head's
group of query heads is split over several blocks per key tile
(``plan``): each sums an fp32 partial, and the last of a tile's blocks to
end (an integer counter finds it) folds them in split order, so two calls
give the same bits with no float atomics.  It runs 12 products per kept
(query, key) pair against the bound's 5 (QK^T and dO V^T three times; P
and dS each as hi + lo into dV, dK and dQ), all bf16 at the tensor cores'
rate, so 2.4 x the bound's time is its own floor; the fold's partials
(128 KB a split block at hd 128) travel through L2.  Operations bound
the function on an H100 at the training shapes (65 us of the bound's 5
products at starcoder2-3b's (4, 1,024, 24 / 2, 128), under 25 us of
bytes)."""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build

#: launches of the tensor-core kernel
launches = 0
#: launches of the CUDA-core kernel
simt_launches = 0
#: launches of the tensor-core backward
bwd_launches = 0
#: launches of the CUDA-core backward
bwd_simt_launches = 0

#: widest head (q/k and value alike) the CUDA-core kernels' shared-memory
#: tiles take
MAX_HEAD_DIM = 256
#: widest q/k head and value head the tensor-core kernels take (each a
#: multiple of MMA_K)
MMA_MAX_HEAD_DIM = 192
MMA_MAX_VALUE_DIM = 128
MMA_K = 16
_DTYPES = (torch.float32, torch.bfloat16)


def _checked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             s_valid: int | None, causal: bool) -> int:
    """Raise unless the kernels take q, k, v; returns s_valid, clipped
    to the key length."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be one of {_DTYPES}, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check(name, t, 4, q.dtype)
    b, sq, h, hd = q.shape
    sk, kv, hv = k.shape[1], k.shape[2], v.shape[-1]
    if k.shape != (b, sk, kv, hd) or v.shape != (b, sk, kv, hv):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if causal and sk != sq:
        raise ValueError(f"a causal call needs as many keys as queries: "
                         f"q {sq}, k {sk}")
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside 1..{MAX_HEAD_DIM}")
    if not 1 <= hv <= MAX_HEAD_DIM:
        raise ValueError(f"value head dim {hv} outside 1..{MAX_HEAD_DIM}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    s_valid = sk if s_valid is None else int(s_valid)
    if s_valid < 1:
        raise ValueError(f"s_valid must be >= 1, got {s_valid}")
    return min(s_valid, sk)


def uses_tensor_cores(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> bool:
    """Whether ``flash_attention`` (and its backward) takes the tensor-core
    kernels: bf16, hd and hv multiples of 16, hd up to 192 and hv up to
    128, and 16-byte aligned bases (their copies move 16 bytes at a
    time)."""
    hd, hv = q.shape[-1], v.shape[-1]
    return (q.dtype == torch.bfloat16 and hd % MMA_K == 0
            and hv % MMA_K == 0 and hd <= MMA_MAX_HEAD_DIM
            and hv <= MMA_MAX_VALUE_DIM
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, s_valid: int, *extra,
            lse: torch.Tensor | None = None) -> torch.Tensor:
    b, s, h, hd = q.shape
    hv = v.shape[-1]
    out = q.new_empty((b, s, h, hv))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if lse is not None:
        name, ptrs = name + "_lse", ptrs + (lse.data_ptr(),)
    _build.launch(name, *ptrs, b, s, k.shape[1], h, k.shape[2], hd, hv,
                  s_valid, int(causal), 1.0 / math.sqrt(hd), *extra,
                  q.device.index, stream)
    return out


def _lse_out(q: torch.Tensor) -> torch.Tensor:
    b, s, h, _ = q.shape
    return torch.empty((b, h, s), dtype=torch.float32, device=q.device)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, s_valid: int | None = None,
                    with_lse: bool = False):
    """q: (B, Sq, H, hd); k: (B, Sk, KV, hd); v: (B, Sk, KV, hv) CUDA,
    all fp32 or all bf16, H a multiple of KV, Sk = Sq when ``causal`` ->
    (B, Sq, H, hv) in q's dtype.  Keys at or after ``s_valid`` (default
    Sk) carry no mass.  ``with_lse`` also returns the (B, H, Sq) fp32
    natural-log sum of exp(q.k / sqrt(hd)) over each row's keys, the
    backward's residual: ``(out, lse)``."""
    global launches
    s_valid = _checked(q, k, v, s_valid, causal)
    if not uses_tensor_cores(q, k, v):
        return flash_attention_simt(q, k, v, causal=causal, s_valid=s_valid,
                                    with_lse=with_lse)
    lse = _lse_out(q) if with_lse else None
    if q.numel() == 0:
        out = q.new_empty((*q.shape[:3], v.shape[-1]))
    else:
        out = _launch("flash_attention", q, k, v, causal, s_valid, lse=lse)
        launches += 1
    return (out, lse) if with_lse else out


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, s_valid: int | None = None,
                         with_lse: bool = False):
    """The CUDA-core kernel alone, for any input ``flash_attention`` takes
    (fp32 or bf16, hd and hv up to 256)."""
    global simt_launches
    s_valid = _checked(q, k, v, s_valid, causal)
    lse = _lse_out(q) if with_lse else None
    if q.numel() == 0:
        out = q.new_empty((*q.shape[:3], v.shape[-1]))
    else:
        out = _launch("flash_attention_simt", q, k, v, causal, s_valid,
                      int(q.dtype == torch.bfloat16), lse=lse)
        simt_launches += 1
    return (out, lse) if with_lse else out


# --- the backward's plan ------------------------------------------------------

#: the dK/dV kernel's block holds KEY_TILE keys (two consumer warpgroups of
#: 64; WIDE_KEY_TILE at (192, 128), where the two split dK and dV) and
#: sweeps QUERY_STEP queries of one head a step; the dQ kernel's holds
#: DQ_QUERY_TILE queries and sweeps the keys 64 a step
KEY_TILE = 128
WIDE_KEY_TILE = 64
QUERY_STEP = 64
DQ_QUERY_TILE = 128
#: an H100 SXM's streaming multiprocessors; either kernel fits one block an
#: SM (384 threads, ~161 KB of shared memory)
H100_SMS = 132
#: the plan's model of a dK/dV block's time, in steps (one 64-query step
#: of its 128 keys: 6 bf16 products of 64 x 64 x hd a warpgroup), from
#: peak rates of one SM: 989 TFLOP/s / 132 for the products and an
#: assumed 100 GB/s of L2 traffic an SM for the copies.  Every block first
#: loads its K and V tiles; a split tile's blocks each write an fp32
#: partial, and the last one reads them all back.
SM_FLOPS = 989e12 / H100_SMS
SM_L2_BYTES_PER_S = 100e9


def _hd_p(hd: int, hv: int | None = None) -> int:
    """The compiled q/k width the tensor-core backward runs a head of hd
    columns (and hv value columns, default hd) at: 64 or 128 for hv = hd,
    192 for any hv != hd."""
    if hv is not None and hv != hd:
        return 192
    return 64 if hd <= 64 else 128


def _hv_p(hd: int, hv: int | None = None) -> int:
    """The compiled value width beside ``_hd_p``: 64, 128, or 128 at 192."""
    return min(_hd_p(hd, hv), 128)


def key_tile(hd: int, hv: int | None = None) -> int:
    """Keys a dK/dV block of the tensor-core backward holds."""
    return WIDE_KEY_TILE if _hd_p(hd, hv) + _hv_p(hd, hv) > 256 else KEY_TILE


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the tensor-core backward covers one call.

    steps[kt]: the (query head, query step) steps of key tile kt (each
    batch and KV head alike); splits[kt]: the blocks they are cut into,
    ceil(steps / chunk), each taking steps [j n / ns, (j + 1) n / ns)."""
    chunk: int
    key_tile: int           # keys a dK/dV block holds
    steps: tuple[int, ...]
    splits: tuple[int, ...]
    blocks: int             # the dK/dV grid: key tiles in order, each
    #                         (b, KV head)'s shares together
    dq_blocks: int
    waves: int              # of the dK/dV grid over the SMs
    longest: float          # the longest dK/dV block's modelled steps
    fold_bytes: int         # partials written and read by the folds
    workspace_floats: int   # fp32 partials, one slot per dK/dV block
    counters: int           # fold counters, one per (key tile, b, KV head)

    def shares(self, kt: int) -> list[tuple[int, int]]:
        """Key tile kt's step ranges, one per block, in split order."""
        n, ns = self.steps[kt], self.splits[kt]
        return [(j * n // ns, (j + 1) * n // ns) for j in range(ns)]


def plan(b: int, s: int, h: int, kv: int, hd: int, causal: bool, *,
         hv: int | None = None, sk: int | None = None,
         sms: int = H100_SMS) -> Plan:
    """The dK/dV grid of ``flash_attention_bwd``'s tensor-core route for
    ``s`` queries over ``sk`` keys (default s; a causal call has sk = s),
    a q/k width hd and a value width hv (default hd): key tiles over the
    sk keys, each with its (query head, query step) steps over the s
    queries, and the step limit ``chunk`` with the least waves x longest
    block (in modelled steps, the fold's copies counted; ties to fewer
    blocks)."""
    sk = s if sk is None else sk
    if causal and sk != s:
        raise ValueError(f"a causal call needs as many keys as queries: "
                         f"q {s}, k {sk}")
    group = h // kv
    hd_p, hv_p = _hd_p(hd, hv), _hv_p(hd, hv)
    tile = key_tile(hd, hv)
    n_qt = -(-s // QUERY_STEP)
    n_kt = -(-sk // tile)
    steps = tuple(group * (n_qt - (kt * tile // QUERY_STEP
                                   if causal else 0)) for kt in range(n_kt))
    # a step's products, in units of 64 x 64 x 1: each consumer's S^T and
    # dP^T (depth hd_p and hv_p), and dV's and dK's hi + lo (widths hv_p
    # and hd_p), each consumer both over its own 64 keys, or (the wide
    # tile) one each over the block's 64
    units = 2 * (hd_p + hv_p) + (2 if tile == WIDE_KEY_TILE else 4) * (
        hd_p + hv_p)
    step_s = 2 * 64 * QUERY_STEP * units / SM_FLOPS
    # the fold's fp32 partial of a block: every consumer's slot
    atoms = (hd_p // 64 if tile == WIDE_KEY_TILE
             else (hd_p + hv_p) // 64)
    partial = 2 * 128 * 32 * atoms * 4
    partial_steps = partial / SM_L2_BYTES_PER_S / step_s
    kv_steps = tile * (hd_p + hv_p) * 2 / SM_L2_BYTES_PER_S / step_s
    best = None
    for chunk in range(max(steps), 0, -1):
        splits = tuple(max(1, -(-n // chunk)) for n in steps)
        blocks = b * kv * sum(splits)
        longest = max(-(-n // ns) + kv_steps
                      + ((ns + 1) * partial_steps if ns > 1 else 0.0)
                      for n, ns in zip(steps, splits))
        waves = -(-blocks // sms)
        cost = waves * longest
        if best is None or cost < best[0]:
            best = (cost, chunk, splits, blocks, waves, longest)
    _, chunk, splits, blocks, waves, longest = best
    split_blocks = b * kv * sum(ns for ns in splits if ns > 1)
    return Plan(chunk=chunk, key_tile=tile, steps=steps, splits=splits,
                blocks=blocks,
                dq_blocks=b * h * -(-s // DQ_QUERY_TILE), waves=waves,
                longest=longest, fold_bytes=2 * split_blocks * partial,
                workspace_floats=(blocks * partial // 4
                                  if split_blocks else 0),
                counters=b * kv * n_kt)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor, *,
                        causal: bool = True, s_valid: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` for the
    output gradient ``dout``, given the forward's ``lse`` (from
    ``with_lse=True``): q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV,
    hv) and dout (B, Sq, H, hv) in one dtype (Sk = Sq when causal), lse
    (B, H, Sq) fp32; dq comes out like q, dk and dv like k and v.  The
    probabilities are recomputed from lse, and D = rowsum(dout o out) as
    rowsum(P o dP) from them in fp32, so the forward's output is not read
    (its rounding to q's dtype would enter every dS).  Every gradient
    element is summed in a fixed order, so two calls give the same bits.
    bf16 at the tensor-core widths takes the tensor-core kernels (grid
    from ``plan``), anything else the CUDA-core ones."""
    global bwd_launches, bwd_simt_launches
    s_valid = _checked(q, k, v, s_valid, causal)
    _build.check("dout", dout, 4, q.dtype)
    b, s, h, hd = q.shape
    sk, hv = k.shape[1], v.shape[-1]
    if dout.shape != (b, s, h, hv):
        raise ValueError(f"dout {tuple(dout.shape)} != {(b, s, h, hv)}")
    _build.check("lse", lse, 3)
    if lse.shape != (b, h, s):
        raise ValueError(f"lse {tuple(lse.shape)} != {(b, h, s)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    tc = uses_tensor_cores(q, k, v) and all(
        t.data_ptr() % 16 == 0 for t in (dout, dq, dk, dv))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kv = k.shape[2]
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr()]
    ints = [b, s, sk, h, kv, hd, hv, s_valid, int(causal),
            1.0 / math.sqrt(hd)]
    if tc:
        p = plan(b, s, h, kv, hd, causal, hv=hv, sk=sk,
                 sms=_sms(q.device.index))
        ws = torch.empty(p.workspace_floats, dtype=torch.float32,
                         device=q.device)
        counters = torch.empty(p.counters, dtype=torch.int32,
                               device=q.device)
        _build.launch("flash_attention_bwd", *args, ws.data_ptr(),
                      counters.data_ptr(), *ints, p.chunk, q.device.index,
                      stream)
        bwd_launches += 1
    else:
        _build.launch("flash_attention_bwd_simt", *args, *ints,
                      int(q.dtype == torch.bfloat16), q.device.index, stream)
        bwd_simt_launches += 1
    return dq, dk, dv
