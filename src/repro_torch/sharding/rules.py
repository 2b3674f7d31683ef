"""Sharding rules on a ``(data, model)`` mesh (``repro.sharding.rules``):
the three modes, the path rules of every parameter, and the helpers that
move a tensor between its whole form and a rank's shard.

Modes (``ArchConfig.train_sharding``):

  * ``tp_fsdp``   — Megatron TP over ``model`` + ZeRO-3 over ``data``.
  * ``pure_fsdp`` — the batch over data x model, every parameter stored
                    sharded and gathered whole before use, no backbone TP;
                    the sampled-softmax head stays vocab-parallel over
                    ``model``.
  * ``tp``        — TP only, parameters replicated over data (serving).

Parameter spec symbols (``_RULES``, first match on the reference's
``/``-joined path wins):

  F  — the ZeRO-3 dim: ``data`` (tp_fsdp, pure_fsdp) / replicated (tp)
  Fd — the embedding's, the head's and ``pos_embed``'s feature dim, over
       ``data`` except in tp mode
  M  — the Megatron dim, over ``model`` in every mode (in pure_fsdp it
       shards storage but carries no TP compute)
  V  — the vocab dim, over ``model`` in every mode

A rank holds only its own tensors, so the port has no global arrays and no
``with_sharding_constraint``: a spec is a tuple with one entry a dim
(None, an axis name or a tuple of them, as a ``PartitionSpec``), the
``ShardCtx`` carries this rank's coordinates and the per-axis process
groups, and ``shard_by_spec`` / ``gather_by_spec`` take a whole tensor to
this rank's block and back.  ``compute_view`` is ZeRO-3's gather before
use: every spec axis but the ones compute keeps sharded (``model`` where
the backbone is tensor-parallel) is all-gathered, differentiably, so the
gradient comes back through the gather's backward, a reduce-scatter.
``seq_sharded`` says where the residual stream's sequence lies over
``model`` (``seq_residuals``, the expert configs'), and
``model_partial`` which replicated leaves' gradients each model rank
holds only a part of, so the step sums them over ``model`` as well.

Serving (``ctx_for_serve``: ``tp``, or ``tp_fsdp`` where the config sets
``serve_fsdp``) lays the decode caches out as the reference's
``init_cache`` constrains them (``CACHE_KINDS``, resolved by
``cache_spec``): K/V and MLA's latent rows with the batch over ``data`` and
the SEQUENCE over ``model``, the mamba conv window and state with their
channels over ``model``; each fitted to the shape, so the sequence stays
whole on every model rank where tp does not divide ``max_len`` and the
batch whole on every data rank where dp does not divide it
(``serve_rows``; ``seq_split`` tells a rank's range of a decode cache
from a whole one by the whole length).  ``on_mesh`` tells a mesh ctx
from none.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import torch

from repro_torch.core import distributed

MODES = ("tp_fsdp", "pure_fsdp", "tp")

_A17 = "(ROADMAP.md A17)"


def _axes(entry) -> tuple[str, ...]:
    """A spec entry's axes: () for None, (a,) for a name, the tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Carried through the train step, the index and the engine; ``None``
    mesh = one process, no collectives."""

    mesh: Any = None  # torch.distributed.device_mesh.DeviceMesh | None
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    mode: str = "tp_fsdp"
    seq_residuals: bool = False

    # -- axes ------------------------------------------------------------
    def axis_size(self, axes) -> int:
        """Ranks along ``axes`` (a name, a tuple of names or None)."""
        if self.mesh is None:
            return 1
        return math.prod(self.mesh.size(self.mesh.mesh_dim_names.index(a))
                         for a in _axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's position along ``axes``, the first one major (the
        reference's device order over a tuple of axes)."""
        if self.mesh is None:
            return 0
        i = 0
        for a in _axes(axes):
            i = i * self.axis_size(a) + self.mesh.get_local_rank(a)
        return i

    def group(self, axes):
        """The process group over ``axes`` this rank belongs to, ranks in
        ``axis_index`` order; None for no axes or no mesh."""
        axes = _axes(axes)
        if self.mesh is None or not axes:
            return None
        if len(axes) == 1:
            group = self.mesh.get_group(axes[0])
        elif axes == tuple(self.mesh.mesh_dim_names):
            from repro_torch.launch import mesh as launch_mesh

            group = launch_mesh.flat_group(self.mesh)
        else:
            raise NotImplementedError(f"a group over {axes} {_A17}")
        return distributed.label_group(group, ",".join(axes))

    @property
    def tp(self) -> int:
        """Vocab-parallel degree of the head and the sampler."""
        return self.axis_size(self.model_axis)

    @property
    def tp_backbone(self) -> int:
        """Tensor-parallel degree of the backbone (1 in pure_fsdp)."""
        return 1 if self.mode == "pure_fsdp" else self.tp

    @property
    def batch_axes(self) -> tuple[str, ...]:
        if self.mode == "pure_fsdp":
            return (*self.data_axes, self.model_axis)
        return self.data_axes

    @property
    def dp(self) -> int:
        """Blocks of the batch: ranks over the batch axes."""
        return self.axis_size(self.batch_axes)

    @property
    def model_group(self):
        """The process group of this rank's model column (None unsharded)."""
        return self.group(self.model_axis)

    @property
    def data_group(self):
        """The process group of this rank's data row (None unsharded)."""
        return self.group(self.data_axes)

    @property
    def model_index(self) -> int:
        """This rank's shard of the head: its position on ``model``."""
        return self.axis_index(self.model_axis)

    @property
    def data_index(self) -> int:
        """This rank's position on the data axes."""
        return self.axis_index(self.data_axes)

    @property
    def batch_index(self) -> int:
        """This rank's block of the batch: its position over the batch
        axes, data-major."""
        return self.axis_index(self.batch_axes)

    # -- specs -------------------------------------------------------------
    def fsdp_spec(self):
        """The 'F' resolution (None in tp mode)."""
        if self.mode == "tp":
            return None
        return self.data_spec()

    def data_spec(self):
        ax = self.data_axes
        return ax if len(ax) > 1 else ax[0]

    def fit_spec(self, shape, spec) -> tuple:
        """Drop mesh axes from dims they do not divide; a multi-axis entry
        keeps the longest prefix that divides."""
        entries = list(spec) + [None] * (len(shape) - len(spec))
        out = []
        for dim, a in zip(shape, entries):
            if a is None or dim % self.axis_size(a) == 0:
                out.append(a)
            elif isinstance(a, tuple):
                used, prod = [], 1
                for ax in a:
                    nxt = prod * self.axis_size(ax)
                    if dim % nxt:
                        break
                    prod = nxt
                    used.append(ax)
                out.append(tuple(used) if len(used) > 1
                           else (used[0] if used else None))
            else:
                out.append(None)
        return tuple(out)


def local_ctx() -> ShardCtx:
    return ShardCtx(mesh=None)


def mesh_ctx(mesh, mode: str = "tp_fsdp",
             seq_residuals: bool = False) -> ShardCtx:
    """The ctx of a ``(data, model)`` mesh (``launch.mesh``) in ``mode``.
    ``seq_residuals``: the residual stream's sequence over ``model`` in
    tp_fsdp (``seq_sharded``)."""
    assert mode in MODES, mode
    axes = tuple(mesh.mesh_dim_names)
    if axes != ("data", "model"):
        raise NotImplementedError(
            f"a mesh of dims {axes}: only ('data', 'model') is ported; the "
            f"3-D host mesh {_A17}")
    return ShardCtx(mesh=mesh, mode=mode, seq_residuals=seq_residuals)


def ctx_for_train(mesh, cfg) -> ShardCtx:
    return mesh_ctx(mesh, mode=cfg.train_sharding,
                    seq_residuals=cfg.seq_sharded_residuals)


def ctx_for_serve(mesh, cfg) -> ShardCtx:
    """The serving ctx: plain TP (parameters replicated over ``data``), or
    tp_fsdp where the config sets ``serve_fsdp`` (the 132B / 671B MoEs)."""
    return mesh_ctx(mesh, mode="tp_fsdp" if cfg.serve_fsdp else "tp")


def on_mesh(ctx) -> bool:
    """True for a ``ShardCtx`` with a mesh, False for None or an unsharded
    ctx; a ctx that carries a mesh but is not a ``ShardCtx`` raises."""
    if ctx is None or getattr(ctx, "mesh", None) is None:
        return False
    if not isinstance(ctx, ShardCtx):
        raise NotImplementedError(
            f"{type(ctx).__name__} carries a mesh but is not a ShardCtx: "
            "build it with sharding.rules.mesh_ctx (the mesh forms not "
            f"yet ported are listed under {_A17})")
    return True


def seq_sharded(ctx, s: int) -> bool:
    """Whether a (B, S, d) residual-stream activation of ``s`` rows is
    S-sharded over ``model`` (Megatron's sequence parallelism): the
    reference's ``"bO."`` spec, which names ``model`` for the sequence
    where ``seq_residuals`` is set in tp_fsdp, fitted to the shape by
    ``fit_spec``, which drops the axis where it does not divide S (there
    the activation stays replicated over ``model``)."""
    return (on_mesh(ctx) and ctx.seq_residuals and ctx.mode == "tp_fsdp"
            and ctx.tp > 1 and s % ctx.tp == 0)


#: the reference's ``init_cache`` constraints, by cache leaf: K/V (count,
#: B, S, KV, hd), MLA's latent rows (count, B, S, r), the mamba conv
#: window (count, B, K - 1, di) and state (count, B, di, N)
CACHE_KINDS = {"k": ".bS..", "v": ".bS..", "latent": ".bS.",
               "conv": ".b.f", "ssm": ".bf."}


def cache_spec(leaf: str, shape, ctx: ShardCtx) -> tuple:
    """The spec of a decode cache leaf (``CACHE_KINDS``) of WHOLE
    ``shape``, as the reference's ``ShardCtx.spec`` resolves its kind (b
    the batch axes, S ``model``, f ``model`` under a tensor-parallel
    backbone, . none) and ``fit_spec`` fits it; nothing sharded off a
    mesh."""
    if not on_mesh(ctx):
        return (None,) * len(shape)
    batch = ctx.batch_axes if len(ctx.batch_axes) > 1 else ctx.batch_axes[0]
    resolve = {"b": batch, "S": ctx.model_axis,
               "f": ctx.model_axis if ctx.tp_backbone > 1 else None}
    return ctx.fit_spec(tuple(shape), tuple(
        resolve.get(ch) for ch in CACHE_KINDS[leaf]))


def seq_shards(ctx, max_len: int) -> int:
    """The model ranks a decode cache's sequence of ``max_len`` positions
    is split over: its fitted ``"S"`` entry (``cache_spec``), tp where tp
    divides ``max_len``, else 1; 1 off a mesh.  A rank's cache length
    alone does not tell a range of a split sequence from a whole one."""
    if not on_mesh(ctx):
        return 1
    return ctx.axis_size(cache_spec("latent", (1, 1, max_len, 1), ctx)[2])


def seq_split(ctx, local_len: int, whole: int | None, what: str) -> int:
    """``seq_shards`` of a decode cache whose rank holds ``local_len``
    positions of ``whole`` (required: a rank's range of a sequence split
    over the model group is not told from a whole sequence by its
    length), checked against ``local_len``; ``what`` names the cache and
    the argument that gives ``whole`` in the errors."""
    if whole is None:
        raise ValueError(
            f"{what} on a mesh take their whole length: a rank's range of "
            "a sequence split over the model group is not told from a "
            "whole sequence by its length")
    n = seq_shards(ctx, whole)
    if local_len * n != whole:
        raise ValueError(f"{what}: a rank's {local_len} positions are not "
                         f"a block of {whole} split over {n}")
    return n


def local_shape(shape, spec, ctx: ShardCtx) -> tuple:
    """A whole ``shape``'s block on this rank under ``spec`` (the shape
    itself off a mesh)."""
    if not on_mesh(ctx):
        return tuple(shape)
    return tuple(d // ctx.axis_size(e) for d, e in zip(shape, spec))


def serve_rows(x: torch.Tensor, ctx) -> torch.Tensor:
    """This rank's rows of a serving batch: its block over ``data`` where
    dp divides the batch, else the whole batch (the reference's fitted
    ``"b"`` spec: a batch of 1 stays whole on every data rank)."""
    if not on_mesh(ctx) or x.shape[0] % ctx.dp:
        return x
    return batch_rows(x, ctx)


def head_fd_axes(ctx: ShardCtx):
    """Mesh axes of the head's and the embedding's FEATURE dim (the 'Fd'
    rule): the data axes, except in plain-TP serving."""
    if ctx.mode == "tp":
        return None
    return ctx.data_spec()


def vocab_shard(n_rows: int, tp: int) -> int:
    """Head rows per shard: the table padded to a multiple of tp."""
    return -(-n_rows // tp)


def local_n_valid(n: int, v_l: int, shard: int) -> int:
    """True classes among shard ``shard``'s ``v_l`` rows:
    clip(n - shard * v_l, 0, v_l) (``repro.train.step``'s n_valid)."""
    return min(max(n - shard * v_l, 0), v_l)


def pad_rows(x: torch.Tensor, tp: int) -> torch.Tensor:
    """A table padded with zero rows to a multiple of tp (itself if it is
    one)."""
    pad = vocab_shard(x.shape[0], tp) * tp - x.shape[0]
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])


def shard_rows(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """This rank's V-rule rows of a whole table (n, ...): the table padded
    with zero rows to tp * v_l, then rows [j v_l, (j + 1) v_l) for model
    position j.  A copy, contiguous."""
    return shard_by_spec(pad_rows(x, ctx.tp), (ctx.model_axis,), ctx)


def batch_rows(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """This rank's block of a global batch's rows: block ``batch_index``
    of ``dp`` over the batch axes (data-major in pure_fsdp)."""
    dp, i = ctx.dp, ctx.batch_index
    b = x.shape[0]
    if b % dp:
        raise ValueError(f"global batch {b} % batch blocks {dp} != 0")
    per = b // dp
    return x[i * per:(i + 1) * per]


# ---------------------------------------------------------------------------
# Parameter spec rules (the reference's, verbatim).  First regex (on the
# '/'-joined path) wins.  Stacked layer params get leading Nones.
# ---------------------------------------------------------------------------
_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    # embeddings / heads: vocab over model in every mode.
    (r"(^|/)embed/table$", ("V", "Fd")),
    (r"(^|/)head/w$", ("V", "Fd")),
    (r"(^|/)head/bias$", ("V",)),
    (r"(^|/)pos_embed/table$", (None, "Fd")),
    # attention
    (r"/attn/wq$", ("F", "M")),
    (r"/attn/wk$", ("F", "M")),
    (r"/attn/wv$", ("F", "M")),
    (r"/attn/wo$", ("M", "F")),
    (r"/attn/(bq|bk|bv)$", ("M",)),
    (r"/attn/bo$", (None,)),
    (r"/attn/(q_norm|k_norm)/scale$", (None,)),
    # MLA
    (r"/attn/wq_a$", ("F", None)),
    (r"/attn/wq_b$", (None, "M")),
    (r"/attn/wkv_a$", ("F", None)),
    (r"/attn/wkv_b$", (None, "M")),
    (r"/attn/(q_a_norm|kv_a_norm)/scale$", (None,)),
    # mlp
    (r"/mlp/w_gate$", ("F", "M")),
    (r"/mlp/w_up$", ("F", "M")),
    (r"/mlp/w_down$", ("M", "F")),
    (r"/mlp/(b_gate|b_up)$", ("M",)),
    (r"/mlp/b_down$", (None,)),
    # moe: experts over model, reduction dim FSDP over data
    (r"/moe/router$", (None, None)),
    (r"/moe/router_bias$", (None,)),
    (r"/moe/w_gate$", ("M", "Fd", None)),
    (r"/moe/w_up$", ("M", "Fd", None)),
    (r"/moe/w_down$", ("M", None, "Fd")),
    (r"/moe/shared/w_gate$", ("F", "M")),
    (r"/moe/shared/w_up$", ("F", "M")),
    (r"/moe/shared/w_down$", ("M", "F")),
    # mamba: d_inner over model (tp modes); channel-parallel scan
    (r"/mamba/in_proj$", ("F", "M")),
    (r"/mamba/conv_w$", ("M", None)),
    (r"/mamba/conv_b$", ("M",)),
    (r"/mamba/x_proj$", ("M", None)),
    (r"/mamba/dt_proj$", (None, "M")),
    (r"/mamba/dt_bias$", ("M",)),
    (r"/mamba/a_log$", ("M", None)),
    (r"/mamba/d$", ("M",)),
    (r"/mamba/out_proj$", ("M", "F")),
    # lstm / recsys towers
    (r"/lstm\d*/kernel$", ("F", None)),
    (r"/lstm\d*/recurrent$", (None, None)),
    (r"/lstm\d*/bias$", (None,)),
    (r"/tower/w\d+$", ("F", None)),
    (r"/tower/b\d+$", (None,)),
    # norms & scalars
    (r"/(scale|bias)$", (None,)),
    (r"/mtp/proj$", ("F", None)),
]


def _resolve(sym: str | None, ctx: ShardCtx):
    if sym == "F":
        return ctx.fsdp_spec()
    if sym == "Fd":
        return None if ctx.mode == "tp" else ctx.data_spec()
    if sym in ("M", "V"):
        # in pure_fsdp the model axis still SHARDS M params (2-D layout),
        # it just carries no TP compute
        return ctx.model_axis
    return None


_LAYER = re.compile(r"^(segments\.\d+|enc_blocks|dec_blocks)\.(\d+)\.(.+)$")


def ref_path(name: str) -> str:
    """A port parameter's path in the reference's tree, ``/``-joined: a
    ``StackedLM``'s ``segments.<s>.<i>.<path>`` is the stacked leaf
    ``segments/<s>/<path>`` (an ``EncDec``'s ``enc_blocks.<i>.<path>``
    so), another module's dotted name its dots as slashes, a recsys or
    lstm name (no dots) split at its first ``_``."""
    if "." not in name:
        top, _, rest = name.partition("_")
        return f"{top}/{rest}" if rest else top
    m = _LAYER.match(name)
    if m:
        name = f"{m[1]}.{m[3]}"
    return name.replace(".", "/")


def spec_for(name: str, shape, ctx: ShardCtx) -> tuple:
    """The reference's spec of the parameter ``name`` of a whole
    ``shape`` (a layer's view: the stacked leaf's spec without its layer
    dim, the same entries), fitted to the shape."""
    path = ref_path(name)
    for pat, syms in _RULES:
        if re.search(pat, path):
            resolved = tuple(_resolve(s, ctx) for s in syms)
            if len(shape) > len(resolved):
                resolved = (None,) * (len(shape) - len(resolved)) + resolved
            return ctx.fit_spec(tuple(shape), resolved)
    return (None,) * len(shape)


def param_specs_for(params, ctx: ShardCtx) -> dict[str, tuple]:
    """Each named parameter's spec, from its WHOLE shape (a module's
    ``named_parameters()`` or a dict of tensors): the reference's
    ``param_specs_for`` leaf for leaf; nothing sharded unsharded."""
    named = dict(params.named_parameters()) if isinstance(
        params, torch.nn.Module) else params
    if not on_mesh(ctx):
        return {k: (None,) * len(v.shape) for k, v in named.items()}
    return {k: spec_for(k, v.shape, ctx) for k, v in named.items()}


def spec_axes(spec) -> tuple[str, ...]:
    """Every mesh axis a spec shards over, in dim order."""
    return tuple(a for entry in spec for a in _axes(entry))


# --- whole tensor <-> this rank's shard ----------------------------------------


def shard_by_spec(x: torch.Tensor, spec, ctx: ShardCtx) -> torch.Tensor:
    """This rank's block of a whole tensor: along each dim with axes, the
    ``axis_index``-th of ``axis_size`` equal slices.  A contiguous copy."""
    for dim, entry in enumerate(spec):
        n = ctx.axis_size(entry)
        if n > 1:
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"divide over {entry} ({n})")
            size = x.shape[dim] // n
            x = x.narrow(dim, ctx.axis_index(entry) * size, size)
    return x.contiguous().clone()


def gather_by_spec(x: torch.Tensor, spec, ctx: ShardCtx,
                   keep: tuple[str, ...] = ()) -> torch.Tensor:
    """The inverse of ``shard_by_spec``: each dim's shards all-gathered
    over its axes, except dims whose axes are all in ``keep``.
    Differentiable (the gradient through a gather is a reduce-scatter) for
    a float ``x`` that requires grad."""
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if axes and not set(axes) <= set(keep) and ctx.axis_size(axes) > 1:
            x = distributed.all_gather_tiled(x, ctx.group(axes), dim=dim)
    return x


def compute_axes(ctx: ShardCtx) -> tuple[str, ...]:
    """The axes a backbone parameter STAYS sharded over in compute: the
    model axis where the backbone is tensor-parallel (tp_fsdp, tp), none
    in pure_fsdp."""
    return (ctx.model_axis,) if ctx.tp_backbone > 1 else ()


def compute_view(x: torch.Tensor, spec, ctx: ShardCtx) -> torch.Tensor:
    """ZeRO-3's gather before use: the stored shard all-gathered over
    every axis but ``compute_axes``."""
    return gather_by_spec(x, spec, ctx, keep=compute_axes(ctx))


def vocab_group(spec, ctx: ShardCtx):
    """The model group when a table of ``spec`` keeps its vocab rows
    sharded in compute (``compute_view`` under TP: a vocab-parallel
    lookup), else None (the view is whole)."""
    if ctx.model_axis in spec_axes(spec) and \
            ctx.model_axis in compute_axes(ctx):
        return ctx.model_group
    return None


def gather_tree(tree, specs, ctx: ShardCtx):
    """``compute_view`` of every tensor of a nested dict, by the spec at
    the same place in ``specs``."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, specs[k], ctx) for k, v in tree.items()}
    return compute_view(tree, specs, ctx)


def gather_head_fd(ctx: ShardCtx, head_local: torch.Tensor,
                   spec=None) -> torch.Tensor:
    """A (v_l, d / data) head shard with its feature dim all-gathered over
    the data axes (undoing 'Fd'); its vocab rows stay this rank's."""
    spec = spec if spec is not None else (ctx.model_axis,
                                          head_fd_axes(ctx))
    return gather_by_spec(head_local, spec, ctx, keep=(ctx.model_axis,))


def tp_group(ctx):
    """The model group when the backbone is tensor-parallel (Megatron's f
    and g run over it), else None."""
    if not on_mesh(ctx) or ctx.tp_backbone == 1:
        return None
    return ctx.model_group


#: leaves replicated over ``model`` that act on this rank's heads or
#: experts alone under TP, so each model rank holds a part of their
#: gradient: the per-head q/k norms, MLA's latent projections and norms
#: (the latents feed this rank's heads), the router (its combine weights
#: reach this rank's experts)
_HEAD_LOCAL = re.compile(
    r"/attn/(q_norm|k_norm|q_a_norm|kv_a_norm)/scale$"
    r"|/attn/(wq_a|wkv_a)$|/moe/router(_bias)?$")


def model_partial(name: str, spec, ctx: ShardCtx,
                  on_seq_shards: bool) -> bool:
    """Whether the gradient of parameter ``name`` (of ``spec``) is a part
    on each model rank, to be summed over ``model``: a leaf replicated
    over ``model`` under a tensor-parallel backbone that acts on this
    rank's heads or experts alone (``_HEAD_LOCAL``), or on its S-shard of
    the residual stream (``on_seq_shards``: a norm, ``bo``, ``b_down``
    under sequence parallelism).  Replicated compute on replicated rows
    gives every rank the whole gradient, as plain TP does."""
    if ctx.tp_backbone == 1 or ctx.model_axis in spec_axes(spec):
        return False
    return on_seq_shards or bool(_HEAD_LOCAL.search(ref_path(name)))


def grad_reduce_axes(spec, ctx: ShardCtx,
                     partial: bool = False) -> tuple[str, ...]:
    """The axes a parameter's gradient still has to be summed over after
    the backward: the batch axes it is replicated over (a leaf sharded
    over a batch axis is gathered over it in compute, and the gather's
    backward, a reduce-scatter, already summed its gradient; the head's
    vocab rows see the whole of their data row's tokens), then ``model``
    where each model rank holds a part of it (``partial``:
    ``model_partial``)."""
    have = set(spec_axes(spec))
    axes = tuple(a for a in ctx.batch_axes
                 if a not in have and ctx.axis_size(a) > 1)
    if partial and ctx.model_axis not in axes:
        axes += (ctx.model_axis,)
    return axes
