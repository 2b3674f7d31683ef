"""Sharding rules on a ``(data, model)`` mesh (``repro.sharding.rules``),
the part the vocab-parallel head and the batch need.

  V     — the head's vocab rows over ``model`` in every mode: shard ``j``
          of the model group holds rows ``[j * v_l, (j + 1) * v_l)`` of the
          head padded to ``tp * v_l`` rows (the paper's hierarchy: the top
          log2(tp) levels are the shard index, DESIGN.md §2.5).
  batch — the global batch over ``data``: data rank ``i`` holds rows
          ``[i * B / dp, (i + 1) * B / dp)``, the reference's device order.

Every backbone parameter is held whole on each rank.  Its gradients are
all-reduced over the data group and are equal across the model group
(``core/distributed.py::replicated`` sums h's cotangent over the model
group, as shard_map's transpose does for a replicated input), which gives
the reference's numbers.  The backbone's storage layouts (Megatron TP,
ZeRO-3 ``tp_fsdp``, ``pure_fsdp``, ``seq_residuals``) change where
parameters are stored, not what is computed: they are not ported
(ROADMAP.md A17).

A rank holds only its own tensors, so the port has no global arrays and no
``with_sharding_constraint``: ``ShardCtx`` carries this rank's coordinates
and the per-axis process groups instead.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

MODES = ("tp_fsdp", "pure_fsdp", "tp")

_A17 = "(ROADMAP.md A17)"


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Carried through the train step, the index and the engine; ``None``
    mesh = one process, no collectives."""

    mesh: Any = None  # torch.distributed.device_mesh.DeviceMesh | None
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    mode: str = "tp_fsdp"
    seq_residuals: bool = False

    @property
    def tp(self) -> int:
        """Vocab-parallel degree of the head and the sampler."""
        if self.mesh is None:
            return 1
        return self.mesh.size(self.mesh.mesh_dim_names.index(
            self.model_axis))

    @property
    def dp(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.size(self.mesh.mesh_dim_names.index(
            self.data_axes[0]))

    @property
    def model_group(self):
        """The process group of this rank's model column (None unsharded)."""
        return None if self.mesh is None else self.mesh.get_group(
            self.model_axis)

    @property
    def data_group(self):
        """The process group of this rank's data row (None unsharded)."""
        return None if self.mesh is None else self.mesh.get_group(
            self.data_axes[0])

    @property
    def model_index(self) -> int:
        """This rank's shard of the head: its position on ``model``."""
        return 0 if self.mesh is None else self.mesh.get_local_rank(
            self.model_axis)

    @property
    def data_index(self) -> int:
        """This rank's block of the batch: its position on ``data``."""
        return 0 if self.mesh is None else self.mesh.get_local_rank(
            self.data_axes[0])


def local_ctx() -> ShardCtx:
    return ShardCtx(mesh=None)


def mesh_ctx(mesh, mode: str = "tp_fsdp",
             seq_residuals: bool = False) -> ShardCtx:
    """The ctx of a ``(data, model)`` mesh (``launch.mesh``).  ``tp_fsdp``
    and ``tp`` hold the backbone whole in this part, so both compute the
    same; ``pure_fsdp`` and ``seq_residuals`` change what a step computes
    and raise."""
    assert mode in MODES, mode
    if mode == "pure_fsdp" or seq_residuals:
        raise NotImplementedError(
            "pure_fsdp and seq_residuals (the batch over the model axis, "
            f"the S-sharded residual stream) are not ported {_A17}")
    axes = tuple(mesh.mesh_dim_names)
    if axes != ("data", "model"):
        raise NotImplementedError(
            f"a mesh of dims {axes}: only ('data', 'model') is ported; the "
            f"3-D host mesh {_A17}")
    return ShardCtx(mesh=mesh, mode=mode, seq_residuals=seq_residuals)


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


def vocab_shard(n_rows: int, tp: int) -> int:
    """Head rows per shard: the table padded to a multiple of tp."""
    return -(-n_rows // tp)


def local_n_valid(n: int, v_l: int, shard: int) -> int:
    """True classes among shard ``shard``'s ``v_l`` rows:
    clip(n - shard * v_l, 0, v_l) (``repro.train.step``'s n_valid)."""
    return min(max(n - shard * v_l, 0), v_l)


def shard_rows(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """This rank's V-rule rows of a whole table (n, ...): the table padded
    with zero rows to tp * v_l, then rows [j v_l, (j + 1) v_l) for model
    position j.  A copy, contiguous."""
    tp, j = ctx.tp, ctx.model_index
    v_l = vocab_shard(x.shape[0], tp)
    rows = x[j * v_l:(j + 1) * v_l]
    pad = v_l - rows.shape[0]
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, *x.shape[1:]))])
    return rows.contiguous().clone()


def batch_rows(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """This data rank's block of a global batch's rows."""
    dp, i = ctx.dp, ctx.data_index
    b = x.shape[0]
    if b % dp:
        raise ValueError(f"global batch {b} % data ranks {dp} != 0")
    per = b // dp
    return x[i * per:(i + 1) * per]


#: the V rule's parameters: the head (recsys ``head_w``, an LM's
#: ``head.w``); the embedding table is a backbone input, held whole here
_HEAD = re.compile(r"(^|[./_])head[._]?(w|bias)$")


def param_specs_for(params, ctx: ShardCtx) -> dict[str, tuple]:
    """Each named parameter's spec: the head's rows over ``model`` (the V
    rule), nothing sharded unsharded.  The backbone's rules (F, Fd, M)
    are not ported: a backbone leaf on a mesh raises."""
    named = dict(params.named_parameters()) if isinstance(
        params, torch.nn.Module) else params
    out = {}
    for name, leaf in named.items():
        if not on_mesh(ctx):
            out[name] = (None,) * leaf.dim()
        elif _HEAD.search(name):
            out[name] = (ctx.model_axis,) + (None,) * (leaf.dim() - 1)
        else:
            raise NotImplementedError(
                f"the backbone's parameter specs ({name}: Megatron TP, "
                f"ZeRO-3) are not ported {_A17}; this part holds the "
                "backbone whole on each rank")
    return out
