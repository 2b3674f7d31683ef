"""Adafactor (Shazeer & Stern 2018): factored second moments
(``repro.optim.adafactor``).

The reference's defaults and math: decay 0.99, eps 1e-30, update clipping
at RMS 1, no weight decay.  A leaf of two or more dimensions keeps row and
column statistics (``vr`` over its last axis, ``vc`` over its second to
last), any other leaf the full ``v``; the update's RMS is taken over the
whole leaf.

The reference factors each STACKED leaf of an LM (a segment's layers on a
leading axis; an encoder-decoder's encoder and decoder blocks).  The port
trains a ``StackedLM``, whose parameter ``segments.<s>.<i>.<path>`` is
layer i's view of the stacked leaf ``segments.<s>.<path>``, or an
``EncDec``, whose ``enc_blocks.<i>.<path>`` (``dec_blocks`` likewise) is
layer i's view of ``enc_blocks.<path>``; this transform groups the views
back into their stack by that name and keeps the state in the
reference's shapes, keyed by stack (``{"v": {stack: {"vr", "vc"} or {"v"}}, "step"}``; a parameter
outside a segment is its own stack).  So a (count, a, b) leaf keeps
(count, a) and (count, b) statistics, layer by layer; a (count, d) leaf
(a norm scale, mamba's ``d``) is factored ACROSS its layers, ``vr``
(count,) and one ``vc`` (d,) shared by them; and the update's RMS is the
stack's.

Memory: nothing of a stack's size is materialised.  The statistics are
gathered one 2-D matrix (a layer, or one expert of it) at a time, and a
matrix's fp32 temporaries a piece of its rows at a time
(``transform.PIECE`` elements: deepseek-v3-671b's 129,280 x 7,168 head is
3.5 GB in fp32); the update is
computed twice, once for the stack's sum of squares and once to apply,
and ``update`` adds it to the parameters IN PLACE (an fp32 update of
falcon-mamba-7b's ``in_proj`` stack would take 17 GB) and returns no
updates, so ``apply_updates`` after it adds nothing.

On a mesh (gradients as ``clip.ShardedGrads``, each leaf a rank's
shard) the state takes the shards' shapes, and every mean is the whole
leaf's: ``vr``'s over its columns, ``vc``'s and the row statistics' mean
over its rows, the RMS over all of it, each a local sum psum'd over the
axes that shard the reduced dim and divided by the global count.  A dim
no axis shards is reduced locally, so a replicated leaf counts once."""
from __future__ import annotations

import re

import torch

from repro_torch.optim import transform
from repro_torch.optim.clip import ShardedGrads
from repro_torch.optim.transform import GradientTransform

_LAYER = re.compile(r"^(segments\.\d+|enc_blocks|dec_blocks)\.(\d+)\.(.+)$")


def stacks(names) -> dict[str, list[str]]:
    """Parameter names grouped by the stacked leaf they are views of,
    layers in order: ``segments.<s>.<i>.<path>`` under
    ``segments.<s>.<path>``, ``enc_blocks.<i>.<path>`` under
    ``enc_blocks.<path>`` (and ``dec_blocks`` so), any other name alone
    under itself."""
    out: dict[str, dict[int, str]] = {}
    for name in names:
        m = _LAYER.match(name)
        key, i = (f"{m[1]}.{m[3]}", int(m[2])) if m else (name, -1)
        out.setdefault(key, {})[i] = name
    return {k: [by[i] for i in sorted(by)] for k, by in out.items()}


def _stack_shape(key: str, members: list[str], params) -> tuple[int, ...]:
    shape = tuple(params[members[0]].shape)
    return (len(members), *shape) if key != members[0] else shape


def _row_pieces(m: torch.Tensor) -> list[slice]:
    """Slices of a matrix's rows of about ``transform.PIECE`` elements
    each."""
    step = max(1, transform.PIECE // max(m.shape[-1], 1))
    return [slice(i, i + step) for i in range(0, m.shape[0], step)]


def _matrices(t: torch.Tensor) -> torch.Tensor:
    """A tensor of two or more dims as a (n, a, b) view of its matrices
    (a view: in-place writes reach ``t``)."""
    return t.view(-1, *t.shape[-2:])


def adafactor(lr, decay: float = 0.99, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> GradientTransform:
    lr_fn = lr if callable(lr) else (lambda _: lr)
    beta = decay

    def init(params):
        v = {}
        for key, members in stacks(params).items():
            shape = _stack_shape(key, members, params)
            dev = params[members[0]].device
            if len(shape) >= 2:
                v[key] = {"vr": torch.zeros(shape[:-1], dtype=torch.float32,
                                            device=dev),
                          "vc": torch.zeros(shape[:-2] + shape[-1:],
                                            dtype=torch.float32, device=dev)}
            else:
                v[key] = {"v": torch.zeros(shape, dtype=torch.float32,
                                           device=dev)}
        device = next(iter(params.values())).device
        return {"v": v,
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def ema(old: torch.Tensor, new: torch.Tensor) -> None:
        old.copy_(beta * old + (1 - beta) * new)

    def sq(g: torch.Tensor) -> torch.Tensor:
        return torch.square(g.float()) + eps

    def mesh_of(grads, name):
        """(the mean over a dim of the whole leaf, psum over axes, the
        rank count of axes, the axes sharding the leaf's rows, its columns
        and all of it); no axes unsharded."""
        if not isinstance(grads, ShardedGrads):
            return ((lambda x, dim, axes: x.mean() if dim is None
                     else x.mean(dim)),
                    (lambda x, axes: x), (lambda axes: 1), (), (), ())
        nd = len(grads.specs[name])
        rows = grads.dim_axes(name, nd - 2) if nd >= 2 else ()
        cols = grads.dim_axes(name, nd - 1) if nd >= 1 else ()

        def mean(x, dim, axes):
            """x's mean over ``dim`` (None: all of it) of the whole
            leaf, whose ``dim`` is sharded over ``axes``."""
            if not axes:
                return x.mean() if dim is None else x.mean(dim)
            if dim is None:
                return grads.psum(x.sum(), axes) / (x.numel()
                                                    * grads.size(axes))
            return grads.psum(x.sum(dim), axes) / (x.shape[dim]
                                                   * grads.size(axes))

        return (mean, grads.psum, grads.size, rows, cols,
                grads.leaf_axes(name))

    def layer_parts(key, members, grads, params, v, cross):
        """The stack in pieces, each (g, p, state views): per layer
        ``(g, p, v)`` of an unfactored stack; per layer ``(g, p, vr[i],
        vc)`` of a cross-layer one; else per 2-D matrix (a layer, or one
        expert of it) ``(g, p, vr, vc)`` with its rows' and columns'
        statistics."""
        stacked = key != members[0]

        def row(t, i):
            return t[i] if stacked else t

        for i, name in enumerate(members):
            g, p = grads[name], params[name]
            if "v" in v:
                yield g, p, row(v["v"], i)
            elif cross:
                yield g, p, v["vr"][i], v["vc"]
            else:
                vr, vc = row(v["vr"], i), row(v["vc"], i)
                yield from zip(_matrices(g.contiguous()), _matrices(p),
                               vr.view(-1, vr.shape[-1]),
                               vc.view(-1, vc.shape[-1]))

    def group_update(key, members, grads, params, v, lr_t):
        # a (count, d) stack: its rows factored across the layers
        cross = "vr" in v and v["vr"].dim() == 1 and key != members[0]
        parts = list(layer_parts(key, members, grads, params, v, cross))
        mean, psum, size, row_ax, col_ax, all_ax = mesh_of(grads,
                                                           members[0])
        # 1. the statistics
        if "v" in v:
            for g, _, vv in parts:
                ema(vv, sq(g))
        elif cross:
            col = torch.zeros_like(v["vc"])
            for g, _, r, _ in parts:
                g2 = sq(g)
                ema(r, mean(g2, None, col_ax))
                col += g2
            ema(v["vc"], col / len(parts))
        else:
            for g, _, r, c in parts:
                col = torch.zeros_like(c)
                rmean = torch.empty_like(r)
                for rows in _row_pieces(g):
                    g2 = sq(g[rows])
                    # a shard's row sums, psum'd below where cols shard
                    rmean[rows] = g2.mean(-1) if not col_ax else g2.sum(-1)
                    col += g2.sum(-2)
                if col_ax:
                    rmean = psum(rmean, col_ax) / (g.shape[-1]
                                                   * size(col_ax))
                ema(r, rmean)
                ema(c, psum(col, row_ax) / (g.shape[0] * size(row_ax)))
        # the update's pieces, each (g, p, its preconditioner): a matrix's
        # rows a piece at a time, its row statistics over their mean
        if "v" in v:
            pieces = [(g, p, vv) for g, p, vv in parts]
        elif cross:
            rmean = torch.clamp(v["vr"].mean(), min=eps)
            pieces = [(g, p, (r / rmean) * c) for g, p, r, c in parts]
        else:
            pieces = []
            for g, p, r, c in parts:
                rs = r / torch.clamp(mean(r, -1, row_ax)[..., None],
                                     min=eps)
                pieces += [(g[rows], p[rows], (rs, rows, c))
                           for rows in _row_pieces(g)]

        def upd_of(piece):
            g, _, pre = piece
            if isinstance(pre, tuple):  # a piece of a factored matrix
                rs, rows, c = pre
                pre = rs[rows][:, None] * c[None, :]
            return g.float() * torch.rsqrt(torch.clamp(pre, min=eps))

        # 2. the stack's RMS; 3. the clipped update, into the parameters
        sumsq = psum(sum(torch.sum(torch.square(upd_of(pc)))
                         for pc in pieces), all_ax)
        numel = sum(part[0].numel() for part in parts) * size(all_ax)
        rms = torch.sqrt(sumsq / numel + 1e-30)
        div = torch.clamp(rms / clip_threshold, min=1.0)
        for piece in pieces:
            u = -lr_t * (upd_of(piece) / div)
            p = piece[1]
            if weight_decay:
                u = u - lr_t * weight_decay * p.float()
            p.add_(u.to(p.dtype))

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        v = state["v"]
        for key, members in stacks(params).items():
            group_update(key, members, grads, params, v[key], lr_t)
        return {}, {"v": v, "step": step}

    return GradientTransform(init, update)
