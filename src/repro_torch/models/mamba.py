"""Mamba-1 selective-state-space block of the port (``repro.models.mamba``,
Gu & Dao 2023).

The selective scan runs time-chunked, as the reference's: a loop over
sequence chunks of ``chunk`` steps carries the (B, d_inner, N) fp32 state,
and within a chunk a work-efficient log-step scan (``_scan_chunk``: pairs
combined level by level, then the even steps filled in) computes every
step's state, so the transient (B, chunk, d_inner, N) tensors stay a
chunk long instead of the whole sequence.  All of it is plain tensor ops:
the reference has no Pallas kernel here.  Under autograd each chunk's
body is checkpointed (``torch.utils.checkpoint``, non-reentrant), as the
reference wraps it in ``jax.checkpoint``: a chunk keeps only its inputs
and its log-step scan runs again in the backward, so the scan's
(B, chunk, d_inner, N) fp32 levels are held for one chunk at a time.

One difference, on purpose: the reference pads the sequence with zeros up
to a multiple of the chunk, and its final state is the state AFTER that
padding (a padded step still decays the state by exp(softplus(dt_bias) A));
the port's last chunk is the remainder, so the state it returns (what
``prefill`` stores in the SSM cache) is the state after the last real
token (ROADMAP.md C).  Every output ``y`` is the same either way.

Decode carries (conv window, ssm state) in the cache: O(1) per token; on
a mesh a rank's cache holds its channels (the reference's ``".b.f"`` and
``".bf."``), and ``mamba_decode`` runs channel-parallel as the block does.

On a ``(data, model)`` mesh under Megatron TP (``tp_fsdp``) the block runs
channel-parallel over the model group (``group``): a rank holds the
channels ``[j di / tp, (j + 1) di / tp)`` of every d_inner-wide leaf, as
the reference's rules store them (``conv_w``, ``conv_b``, ``dt_proj``'s
columns, ``dt_bias``, ``a_log``, ``d``; ``x_proj``'s and ``out_proj``'s
rows), and the scan runs on those channels alone.  ``in_proj`` is stored
over its 2 di columns ``[x_in | z]``, so a rank's stored block is not its
channels: ``mesh_view`` gathers it whole and keeps the rank's columns of
both halves (the gather's backward reduce-scatters the gradient).  The
block's input enters through Megatron's f; ``x_proj`` is row-parallel,
and since every channel then reads the whole (dt, B, C), its partial sums
are all-reduced in the forward AND the backward (g, then f);
``out_proj``'s partial sums leave through g.  Under sequence parallelism
(``seq``) the block's input is this rank's S-shard, all-gathered over S
before ``in_proj`` (the scan runs over the whole sequence of the rank's
channels), and ``out_proj``'s partial sums are reduce-scattered over S
(``layers.tp_enter`` / ``tp_exit``).  The collectives run outside the
scan's chunk checkpoints, so a chunk's recompute runs none.
"""
from __future__ import annotations

import math

import torch
# ``torch.utils.checkpoint`` imports ``torch._dynamo`` at its first call,
# and that import leaves a reference cycle over the calling frames (a
# module-level ``torch.fx.wrap`` keeps its own frame): the first remat
# caller's tensors, a model's weights among them, would stay allocated
# until the cyclic collector happened to run.  Imported here, at module
# level, the cycle holds import frames only.
import torch._dynamo  # noqa: F401
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import distributed
from repro_torch.models.layers import _pdtype, dense_init, tp_enter, tp_exit
from repro_torch.sharding import rules

Tensor = torch.Tensor
Params = dict


def init_mamba(gen: torch.Generator, cfg: ArchConfig,
               device: torch.device) -> Params:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr = cfg.dt_rank
    pd = _pdtype(cfg)
    a = torch.arange(1, n + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(di, 1)
    return {
        "in_proj": dense_init(gen, (d, 2 * di), pd, device),
        "conv_w": dense_init(gen, (di, cfg.ssm_conv), pd, device, scale=0.5),
        "conv_b": torch.zeros((di,), dtype=pd, device=device),
        "x_proj": dense_init(gen, (di, dtr + 2 * n), pd, device),
        "dt_proj": dense_init(gen, (dtr, di), pd, device, scale=dtr ** -0.5),
        # softplus^-1 of 0.01, the middle of U[1e-3, 1e-1]
        "dt_bias": torch.full((di,), math.log(math.expm1(0.01)),
                              dtype=torch.float32, device=device),
        "a_log": torch.log(a),
        "d": torch.ones((di,), dtype=torch.float32, device=device),
    }


def init_mamba_full(gen: torch.Generator, cfg: ArchConfig,
                    device: torch.device) -> Params:
    p = init_mamba(gen, cfg, device)
    p["out_proj"] = dense_init(gen, (cfg.d_inner, cfg.d_model), _pdtype(cfg),
                               device)
    return p


def _causal_conv(x: Tensor, w: Tensor, b: Tensor, prev: Tensor | None = None
                 ) -> tuple[Tensor, Tensor]:
    """Depthwise causal conv over time.  x: (B, S, di), w: (di, K).

    prev: (B, K-1, di) carry-in window (decode / continuation).  Returns
    (y, new_window): the window is the last K-1 steps of prev ++ x.  The
    taps are summed in the reference's order, in x's dtype."""
    k = w.shape[1]
    s = x.shape[1]
    if prev is None:
        prev = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev, x], dim=1)
    y = xp[:, 0:s] * w[:, 0]
    for j in range(1, k):
        y = y + xp[:, j:j + s] * w[:, j]
    y = y + b
    return y, xp[:, -(k - 1):] if k > 1 else prev


def _ssm_params(p: Params, xc: Tensor, cfg: ArchConfig, group=None
                ) -> tuple[Tensor, Tensor, Tensor]:
    """Input-dependent (delta, B, C), each fp32, from the conv output xc:
    (B, L, di); with ``group`` xc is this rank's channels, and the
    row-parallel ``x_proj``'s partial sums are all-reduced both ways."""
    n = cfg.ssm_state
    dtr = cfg.dt_rank
    dbc = xc @ p["x_proj"].to(xc.dtype)  # (B, L, dtr + 2n)
    dbc = distributed.replicated(distributed.psum(dbc, group), group)
    dt, b_ssm, c_ssm = torch.split(dbc, [dtr, n, n], dim=-1)
    # a bf16 product plus the fp32 bias promotes to fp32, as in the
    # reference; softplus is jax.nn.softplus's logaddexp(x, 0)
    pre = dt @ p["dt_proj"].to(dt.dtype) + p["dt_bias"]
    delta = torch.logaddexp(pre.float(), torch.zeros((), device=pre.device))
    return delta, b_ssm.float(), c_ssm.float()


def _scan_chunk(a: Tensor, bx: Tensor, h0: Tensor) -> tuple[Tensor, Tensor]:
    """h_t = a_t * h_{t-1} + bx_t within one chunk, h_{-1} = h0.

    a, bx: (B, L, di, n); h0: (B, di, n).  Returns (h_all, h_last).  The
    carry-in is folded into bx's first step IN PLACE (no copy of a
    chunk-sized tensor)."""
    bx[:, 0] += a[:, 0] * h0
    h_all = _scan(a, bx)
    return h_all, h_all[:, -1]


def _scan(a: Tensor, b: Tensor) -> Tensor:
    """Every h_t of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along dim 1, in
    O(L) work over log2(L) levels: steps (2i, 2i+1) compose to one step
    (a_{2i+1} a_{2i}, a_{2i+1} b_{2i} + b_{2i+1}), whose scan gives the odd
    steps' states; each even step is one step on from the odd before it."""
    n = a.shape[1]
    if n == 1:
        return b
    m = n // 2
    a_ev, a_od = a[:, 0:2 * m:2], a[:, 1:2 * m:2]
    odd = _scan(a_od * a_ev, a_od * b[:, 0:2 * m:2] + b[:, 1:2 * m:2])
    h = torch.empty_like(b)
    h[:, 0] = b[:, 0]
    h[:, 1:2 * m:2] = odd
    h[:, 2::2] = a[:, 2::2] * odd[:, :(n - 1) // 2] + b[:, 2::2]
    return h


def _chunk_body(h: Tensor, delta: Tensor, dx: Tensor, b_ssm: Tensor,
                c_ssm: Tensor, a_mat: Tensor) -> tuple[Tensor, Tensor]:
    """One chunk of the scan from the state h: (y (B, L, di), the state
    after its last step)."""
    da = torch.exp(delta[..., None] * a_mat)
    dbx = dx[..., None] * b_ssm[:, :, None, :]
    h_all, h = _scan_chunk(da, dbx, h)
    del da, dbx
    return torch.einsum("bldn,bln->bld", h_all, c_ssm), h


def _scan_noskip(p: Params, xc: Tensor, cfg: ArchConfig,
                 h0: Tensor | None = None, chunk: int = 256, group=None
                 ) -> tuple[Tensor, Tensor]:
    """The selective scan minus the skip term (D * x is added outside).

    xc: (B, S, di) (a rank's channels with ``group``).  Returns (y (B, S,
    di) fp32, the state after the last token (B, di, n) fp32).  Each chunk
    is checkpointed when autograd records it."""
    b, s, di = xc.shape
    n = cfg.ssm_state
    a_mat = -torch.exp(p["a_log"])
    h = h0 if h0 is not None else torch.zeros(
        (b, di, n), dtype=torch.float32, device=xc.device)
    delta, b_ssm, c_ssm = _ssm_params(p, xc, cfg, group)
    dx = delta * xc.float()
    chunk = min(chunk, s)
    remat = torch.is_grad_enabled() and (delta.requires_grad
                                         or a_mat.requires_grad)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        args = (h, delta[:, sl], dx[:, sl], b_ssm[:, sl], c_ssm[:, sl],
                a_mat)
        if remat:
            y, h = torch.utils.checkpoint.checkpoint(
                _chunk_body, *args, use_reentrant=False)
        else:
            y, h = _chunk_body(*args)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _gate_out(p: Params, y: Tensor, xc: Tensor, z: Tensor,
              group=None, seq: bool = False) -> Tensor:
    """(y + D * xc) * silu(z) @ out_proj, in z's dtype; with ``group`` the
    row-parallel projection's partial sums summed over it (``tp_exit``)."""
    dt = z.dtype
    y = y + p["d"] * xc.float()
    return tp_exit((y.to(dt) * F.silu(z)) @ _out_proj(p).to(dt), group, seq)


def apply_mamba(p: Params, x: Tensor, cfg: ArchConfig,
                chunk: int = 256, group=None, seq: bool = False) -> Tensor:
    """Full-sequence mamba block (train / prefill).  x: (B, S, d); with
    ``group`` channel-parallel over it (``p`` from ``mesh_view``), with
    ``seq`` on S-shards."""
    return mamba_prefill(p, x, cfg, chunk, group, seq)[0]


def mamba_prefill(p: Params, x: Tensor, cfg: ArchConfig, chunk: int = 256,
                  group=None, seq: bool = False) -> tuple[Tensor, Params]:
    """``apply_mamba`` with the cache it leaves: (y (B, S, d), {"conv": the
    last K-1 inputs of the conv (B, K-1, di), "ssm": the state after the
    last token (B, di, n) fp32}): the reference's inline prefill branch
    (``repro.models.transformer.prefill``).  With ``group`` (the module
    docstring) y is whole and the cache holds this rank's channels."""
    dt = x.dtype
    x = tp_enter(x, group, seq)
    xz = x @ p["in_proj"].to(dt)
    di = xz.shape[-1] // 2  # the rank's channels under TP
    x_in, z = xz[..., :di], xz[..., di:]
    xc, window = _causal_conv(x_in, p["conv_w"].to(dt), p["conv_b"].to(dt))
    xc = F.silu(xc)
    y, h_last = _scan_noskip(p, xc, cfg, chunk=chunk, group=group)
    return (_gate_out(p, y, xc, z, group, seq),
            {"conv": window, "ssm": h_last})


def channel_columns(in_proj: Tensor, group) -> Tensor:
    """This rank's columns of a whole ``in_proj`` (d, 2 di): its channels'
    of both halves, ``[x_in | z]`` (d, 2 di / tp)."""
    n, j = distributed.axis_size(group), distributed.axis_index(group)
    di = in_proj.shape[1] // 2
    c = di // n
    return torch.cat([in_proj[:, j * c:(j + 1) * c],
                      in_proj[:, di + j * c:di + (j + 1) * c]], dim=1)


def mesh_view(p: Params, specs: Params, ctx, group=None) -> Params:
    """A mamba block's shards as the block computes on them
    (``rules.compute_view`` of each): whole in pure_fsdp; under TP
    (``group``) this rank's channels, ``in_proj`` gathered whole and cut
    to them (``channel_columns``)."""
    out = {}
    for k, v in p.items():
        if k == "in_proj" and group is not None:
            out[k] = channel_columns(rules.gather_by_spec(v, specs[k], ctx),
                                     group)
        else:
            out[k] = rules.compute_view(v, specs[k], ctx)
    return out


def _out_proj(p: Params) -> Tensor:
    if "out_proj" not in p:
        raise KeyError("mamba params missing out_proj")
    return p["out_proj"]


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Params:
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(p: Params, x: Tensor, cache: Params, cfg: ArchConfig,
                 group=None) -> tuple[Tensor, Params]:
    """Single-token step.  x: (B, 1, d).  Returns (y (B, 1, d), the new
    cache): new tensors, the given cache is left as it was.  With
    ``group`` channel-parallel over it, as ``apply_mamba``: ``p`` this
    rank's channel view (``mesh_view``), the cache its channels'
    conv window and state; y is whole."""
    dt = x.dtype
    x = tp_enter(x, group)
    xz = x @ p["in_proj"].to(dt)
    di = xz.shape[-1] // 2  # the rank's channels under TP
    x_in, z = xz[..., :di], xz[..., di:]
    xc, conv_new = _causal_conv(x_in, p["conv_w"].to(dt), p["conv_b"].to(dt),
                                prev=cache["conv"])
    xc = F.silu(xc)  # (B, 1, di)
    delta, b_ssm, c_ssm = _ssm_params(p, xc, cfg, group)
    a_mat = -torch.exp(p["a_log"])
    da = torch.exp(delta[:, 0, :, None] * a_mat)  # (B, di, n)
    dbx = (delta[:, 0] * xc[:, 0].float())[..., None] * b_ssm[:, 0, None, :]
    h = da * cache["ssm"] + dbx
    y = torch.einsum("bdn,bn->bd", h, c_ssm[:, 0])
    return _gate_out(p, y[:, None], xc, z, group), {"conv": conv_new,
                                                     "ssm": h}
