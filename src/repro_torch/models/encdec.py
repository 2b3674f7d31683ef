"""Encoder-decoder backbone of the port, whisper-style
(``repro.models.encdec``).

The audio frontend (mel + conv downsampling) is a stub, as in the
reference: precomputed frame embeddings (B, S, d_model) go to the encoder
directly.  The rest is the reference's wiring: learned positions (no
RoPE), a pre-norm encoder of non-causal self-attention and GELU MLPs, and
a decoder whose blocks run causal self-attention, cross attention over the
encoder's states and the MLP.

Params are the reference's tree, each block stack on a leading layer axis:
``{"embed": {"table"}, "head": {"w"}, "enc_pos": {"table"}, "dec_pos":
{"table"}, "enc_blocks": {"norm1", "attn", "norm_mlp", "mlp"},
"enc_norm", "dec_blocks": {... , "norm_x", "xattn"}, "dec_norm"}``; the
decoder's cache is ``{"self_k", "self_v", "cross_k", "cross_v"}``, each
(L, B, S, KV, hd).  The reference scans a stack with ``lax.scan``; here a
Python loop runs its layers, each a view of the stacked tensors.  Training
holds the tree as an ``EncDec`` module whose layers are parameters of their
own, views of the stacked tensors (as ``transformer.StackedLM`` holds an
LM); every function here takes either form.  With ``cfg.remat`` set and
grad enabled each layer runs under ``torch.utils.checkpoint``
(non-reentrant), as the reference wraps each layer's body in
``jax.checkpoint``.

Every full-sequence attention goes through ``kernels.ops.flash_attention``
(the CUDA kernels for CUDA tensors, under autograd with their backward;
the plain version for CPU tensors): the encoder's self-attention (not
causal), the decoder's self-attention (causal) and its cross attention
(not causal, the frames' length Sk apart from the tokens' Sq).  The
decoder's one-token step attends with plain tensor ops, as the reference
does: its self cache written in place, the cross K/V precomputed once from
the encoder's output (``init_dec_cache``).

On a ``(data, model)`` mesh an ``EncDec`` holds this rank's shard of every
parameter by the reference's rules (``train.step.shard_params`` sets its
``param_specs``; ``init_encdec(..., ctx=)`` pads the vocab to the head's
vocab-parallel degree and the heads to the backbone's TP degree, as the
reference's does), and ``encode`` / ``decode_train`` run each block on
``rules.compute_view`` of its shards, gathered inside the block's remat
region: whole in ``pure_fsdp``, the Megatron slices in ``tp_fsdp`` (the
self attention and the MLP over ``rules.tp_group``, the embedding
vocab-parallel).  The norms and two kinds of leaves no rule of the
reference matches stay whole on every rank in every mode, as there, and
are used as they are: the cross attention's (``/attn/wq$`` needs a ``/``
where the path has ``xattn``) and the position tables (the rule names
``pos_embed/table``).  Under TP the cross attention therefore
runs whole on every model rank, on the replicated residual stream and
encoder states: no f or g brackets it, and its weights' gradient, alike
over the model group, is summed over the batch axes only
(``rules.grad_reduce_axes``).

Serving on a mesh (``rules.ctx_for_serve``: tp) takes an ``EncDec`` of
a rank's shards and its rows of the batch: ``encode`` runs as above, and
the decoder's cache lays its four leaves out as the reference's
``init_dec_cache`` constrains them (``cache_specs``, ``".bS.."``): the
self K/V of ``max_len`` positions and the cross K/V over the encoder's
frames, each with its sequence over ``model`` where tp divides it.  A
rank projects only its own range of the frames into the cross K/V.  The
one-token step (``decode_step``, told both whole lengths) runs the self
attention Megatron's way over its sequence-sharded cache, the cross
attention with its whole weights over its range of the frames, the
ranges' softmax merged over ``model`` (``layers.attn_decode`` with a
``cache_group`` and no ``group``), the MLP Megatron's and the embedding
vocab-parallel; the ``dec_pos`` table is whole.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import (
    _Tree,
    _layer,
    _map,
    _positions,
    _stacked,
    padded_vocab,
)
from repro_torch.core import distributed
from repro_torch.sharding import rules
from repro_torch.utils.misc import resolve_device

Tensor = torch.Tensor
Params = dict

#: the reference's position-table length when no ``max_len`` is given
DEFAULT_MAX_LEN = 4096
#: the two block stacks, in the tree's order
STACKS = ("enc_blocks", "dec_blocks")


def _init_block(gen: torch.Generator, cfg: ArchConfig, device: torch.device,
                tp: int, cross: bool) -> Params:
    p = {"norm1": L.init_norm(cfg, device),
         "attn": L.init_attention(gen, cfg, device, tp),
         "norm_mlp": L.init_norm(cfg, device),
         "mlp": L.init_mlp(gen, cfg, device)}
    if cross:
        p["norm_x"] = L.init_norm(cfg, device)
        p["xattn"] = L.init_attention(gen, cfg, device, tp)
    return p


def init_encdec(gen: torch.Generator | None, cfg: ArchConfig,
                device: str | torch.device | None = None, tp: int = 1,
                max_len: int = 0, ctx=None) -> Params:
    """Random weights from ``gen`` on ``device`` (the card unless
    ``device="cpu"``), both position tables of ``max_len`` rows (default
    DEFAULT_MAX_LEN).  Heads and vocab are padded to a multiple of ``tp``;
    with a mesh ``ctx`` the heads to its backbone's TP degree and the
    vocab to its head's (``ctx.tp_backbone``, ``ctx.tp``), as the
    reference's ``init_encdec``.  Vocab rows at and after ``vocab_size``
    are zero, as in the reference.  On the ``meta`` device nothing is
    drawn."""
    dev = resolve_device(device)
    max_len = max_len or DEFAULT_MAX_LEN
    nvp = padded_vocab(cfg, ctx.tp if rules.on_mesh(ctx) else tp)
    if rules.on_mesh(ctx):
        tp = ctx.tp_backbone
    pd = L._pdtype(cfg)
    emb = L.dense_init(gen, (nvp, cfg.d_model), pd, dev, scale=0.02)
    emb[cfg.vocab_size:] = 0
    head = L.dense_init(gen, (nvp, cfg.d_model), pd, dev, scale=0.02)
    head[cfg.vocab_size:] = 0
    return {
        "embed": {"table": emb},
        "head": {"w": head},
        "enc_pos": L.init_pos_embed(gen, cfg, max_len, dev),
        "dec_pos": L.init_pos_embed(gen, cfg, max_len, dev),
        "enc_blocks": _stacked(cfg.n_enc_layers, lambda: _init_block(
            gen, cfg, dev, tp, cross=False)),
        "enc_norm": L.init_norm(cfg, dev),
        "dec_blocks": _stacked(cfg.n_dec_layers, lambda: _init_block(
            gen, cfg, dev, tp, cross=True)),
        "dec_norm": L.init_norm(cfg, dev),
    }


class EncDec(nn.Module):
    """An encoder-decoder's parameters as a module, for training.

    ``tree`` is ``init_encdec``'s (or ``convert.params_from_jax``'s)
    stacked tree; each encoder and decoder layer becomes a submodule whose
    parameters are views of the stacked tensors, so nothing is copied.
    Without a tree the parameters are allocated (``torch.empty``, position
    tables of ``max_len`` rows; on the ``meta`` device nothing at all).
    Parameter names follow the tree: ``embed.table``, ``enc_pos.table``,
    ``enc_blocks.<i>.attn.wq``, ``dec_blocks.<i>.xattn.wk``,
    ``dec_norm.scale``...  ``convert`` stacks them back into the
    reference's layout."""

    #: {name: spec} of a mesh rank's shards (``train.step.shard_params``);
    #: None: every parameter whole
    param_specs: dict | None = None

    def __init__(self, cfg: ArchConfig, device: str | torch.device,
                 tree: Params | None = None, tp: int = 1,
                 max_len: int = 0, ctx=None):
        super().__init__()
        if tree is None:
            dev = torch.device(device)
            tree = _map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device=dev),
                        init_encdec(None, cfg, "meta", tp, max_len, ctx))
        counts = _counts(cfg)
        for key, val in tree.items():
            self.add_module(key, nn.ModuleList(
                _Tree(_layer(val, i)) for i in range(counts[key]))
                if key in counts else _Tree(val))

    def tree(self, leaf=None) -> Params:
        """The parameters as the reference's tree, each block stack a list
        of per-layer dicts; with ``leaf``, ``leaf(name, parameter)`` in
        each parameter's place."""
        return {key: ([layer.tree(leaf, f"{key}.{i}.")
                       for i, layer in enumerate(mod)]
                      if key in STACKS else mod.tree(leaf, f"{key}."))
                for key, mod in self.named_children()}

    def spec_tree(self) -> Params | None:
        """``tree()`` with each parameter's spec in its place (None when
        the parameters are whole)."""
        if self.param_specs is None:
            return None
        return self.tree(lambda name, _: self.param_specs[name])


def _counts(cfg: ArchConfig) -> dict[str, int]:
    return dict(zip(STACKS, (cfg.n_enc_layers, cfg.n_dec_layers)))


def _top(params) -> Params:
    return params.tree() if isinstance(params, EncDec) else params


def _blocks(top: Params, key: str, cfg: ArchConfig) -> list[Params]:
    """Per layer, its param dict: an ``EncDec``'s own (``top`` from its
    ``tree()``), or views of a stacked tree."""
    stack = top[key]
    if isinstance(stack, list):
        return stack
    return [_layer(stack, i) for i in range(_counts(cfg)[key])]


def _run(fn, remat: bool, *args):
    """``fn(*args)``, checkpointed under ``remat``."""
    if remat:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _mlp(blk: Params, x: Tensor, cfg: ArchConfig, group=None) -> Tensor:
    return x + L.apply_mlp(blk["mlp"], L.apply_norm(blk["norm_mlp"], x, cfg),
                           cfg, group=group)


def _mesh_specs(params, ctx) -> Params | None:
    """The spec tree of an ``EncDec`` of a rank's shards on a mesh
    ``ctx``; None off a mesh."""
    if not rules.on_mesh(ctx):
        return None
    specs = params.spec_tree() if isinstance(params, EncDec) else None
    if specs is None:
        raise ValueError("on a mesh the encoder-decoder takes an EncDec of "
                         "the rank's shards (train.step.shard_params)")
    return specs


def _stack_specs(specs: Params | None, key: str, cfg: ArchConfig) -> list:
    return specs[key] if specs is not None else [None] * _counts(cfg)[key]


def _gathered(blk: Params, ctx, specs: Params | None):
    """A block's params as compute uses them and the TP group: its shards'
    ``compute_view`` on a mesh (``specs``), else itself and None."""
    if specs is None:
        return blk, None
    return rules.gather_tree(blk, specs, ctx), rules.tp_group(ctx)


def _enc_block(blk: Params, x: Tensor, positions: Tensor, cfg: ArchConfig,
               ctx=None, specs: Params | None = None) -> Tensor:
    blk, group = _gathered(blk, ctx, specs)
    h = L.apply_norm(blk["norm1"], x, cfg)
    x = x + L.attn_forward(blk["attn"], h, positions, cfg, causal=False,
                           group=group)
    return _mlp(blk, x, cfg, group)


def encode(params, frames: Tensor, cfg: ArchConfig, ctx=None) -> Tensor:
    """frames: (B, S, d) precomputed embeddings (the frontend stub) ->
    the encoder's states (B, S, d) in the compute dtype; differentiable.
    On a mesh ``params`` is an ``EncDec`` of the rank's shards and
    ``frames`` its batch rows (the module docstring)."""
    specs = _mesh_specs(params, ctx)
    top = _top(params)
    b, s, _ = frames.shape
    x = frames.to(L._dtype(cfg))
    x = x + top["enc_pos"]["table"][:s][None].to(x.dtype)
    positions = _positions(b, s, frames.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for blk, bs in zip(_blocks(top, "enc_blocks", cfg),
                       _stack_specs(specs, "enc_blocks", cfg)):
        x = _run(_enc_block, remat, blk, x, positions, cfg, ctx, bs)
    return L.apply_norm(top["enc_norm"], x, cfg)


def cross_attention(p: Params, x: Tensor, enc_out: Tensor, cfg: ArchConfig
                    ) -> Tensor:
    """The decoder's cross attention, full sequence: q from x (B, Sq, d),
    k and v from the encoder's states (B, Sk, d) (``layers.cross_kv``),
    one ``ops.flash_attention`` call, not causal, at the two lengths.
    Only q is projected from x (the reference's ``_qkv`` also projects k
    and v there and drops them)."""
    dt = L._dtype(cfg)
    b, s = x.shape[0], x.shape[1]
    k, v = L.cross_kv(p, enc_out, cfg)
    q = x @ p["wq"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
    q = q.reshape(b, s, -1, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = L.rms_norm_only(q, p["q_norm"]["scale"])
    out = ops.flash_attention(q, k, v, causal=False)
    return out.reshape(b, s, -1) @ p["wo"].to(dt)


def _dec_block(blk: Params, x: Tensor, enc_out: Tensor, positions: Tensor,
               cfg: ArchConfig, ctx=None, specs: Params | None = None
               ) -> Tensor:
    blk, group = _gathered(blk, ctx, specs)
    h = L.apply_norm(blk["norm1"], x, cfg)
    x = x + L.attn_forward(blk["attn"], h, positions, cfg, causal=True,
                           group=group)
    hx = L.apply_norm(blk["norm_x"], x, cfg)
    # whole on every rank (replicated weights; the module docstring)
    x = x + cross_attention(blk["xattn"], hx, enc_out, cfg)
    return _mlp(blk, x, cfg, group)


def _dec_embed(top: Params, tokens: Tensor, cfg: ArchConfig, ctx,
               specs: Params | None) -> Tensor:
    """The decoder's token embeddings; on a mesh (``specs``) the table's
    ``compute_view``, vocab-parallel under TP."""
    if specs is None:
        return L.apply_embed(top["embed"], tokens, cfg)
    spec = specs["embed"]["table"]
    return L.apply_embed(
        {"table": rules.compute_view(top["embed"]["table"], spec, ctx)},
        tokens, cfg, rules.vocab_group(spec, ctx))


def decode_train(params, tokens: Tensor, enc_out: Tensor, cfg: ArchConfig,
                 ctx=None) -> Tensor:
    """The teacher-forced decoder: tokens (B, S) over the encoder's states
    (B, Sf, d) -> hidden states (B, S, d); differentiable.  On a mesh the
    rank's batch rows through its shards, the embedding vocab-parallel
    under TP."""
    specs = _mesh_specs(params, ctx)
    top = _top(params)
    b, s = tokens.shape
    x = _dec_embed(top, tokens, cfg, ctx, specs)
    x = x + top["dec_pos"]["table"][:s][None].to(x.dtype)
    positions = _positions(b, s, tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for blk, bs in zip(_blocks(top, "dec_blocks", cfg),
                       _stack_specs(specs, "dec_blocks", cfg)):
        x = _run(_dec_block, remat, blk, x, enc_out, positions, cfg, ctx,
                 bs)
    return L.apply_norm(top["dec_norm"], x, cfg)


def _cache_shapes(cfg: ArchConfig, batch: int, max_len: int, frames: int,
                  tp: int = 1) -> dict[str, tuple]:
    """The decoder cache's WHOLE leaf shapes: (L, B, S, KV, hd), S being
    ``max_len`` for the self K/V and ``frames`` for the cross K/V, KV the
    heads padded for the backbone's TP degree ``tp``, as the reference's
    ``init_dec_cache``."""
    _, nkv = L.padded_heads(cfg, tp)
    own = (cfg.n_dec_layers, batch, max_len, nkv, cfg.resolved_head_dim)
    cross = (cfg.n_dec_layers, batch, frames, nkv, cfg.resolved_head_dim)
    return {"self_k": own, "self_v": own, "cross_k": cross,
            "cross_v": cross}


def _tp(ctx) -> int:
    return ctx.tp_backbone if rules.on_mesh(ctx) else 1


def cache_specs(cfg: ArchConfig, batch: int, max_len: int, frames: int,
                ctx=None) -> dict[str, tuple]:
    """The spec of each leaf of the decoder's cache of a WHOLE batch of
    ``batch``, ``max_len`` positions and ``frames`` encoder frames: the
    reference's ``".bS.."`` for all four (``rules.cache_spec``, fitted:
    each sequence over ``model`` where tp divides it, the batch over
    ``data`` where dp does); nothing sharded off a mesh."""
    return {k: rules.cache_spec("k", sh, ctx) for k, sh in _cache_shapes(
        cfg, batch, max_len, frames, _tp(ctx)).items()}


@torch.no_grad()
def init_dec_cache(params, cfg: ArchConfig, batch: int, max_len: int,
                   enc_out: Tensor, ctx=None) -> dict[str, Tensor]:
    """The decoder's cache on ``enc_out``'s device: a zero self-attention
    K/V of ``max_len`` positions and the cross attention's K/V of every
    layer from the encoder's states (B, Sf, d), each (L, B, S, KV, hd) in
    the compute dtype; each layer's cross K/V is written into its slot of
    the stack as it is projected, so no second copy is held.

    On a serving mesh ``params`` is an ``EncDec`` of the rank's shards,
    ``batch`` the WHOLE batch and ``enc_out`` the states of the rank's
    rows: each leaf is the rank's block by ``cache_specs``, and the rank
    projects only its own range of the frames (with the cross attention's
    whole ``wk`` / ``wv``)."""
    specs = _mesh_specs(params, ctx)
    dt = L._dtype(cfg)
    frames = enc_out.shape[1]
    shapes = _cache_shapes(cfg, batch, max_len, frames, _tp(ctx))
    cspecs = cache_specs(cfg, batch, max_len, frames, ctx)
    dev = enc_out.device
    cache = {k: (torch.zeros if k.startswith("self") else torch.empty)(
        rules.local_shape(shapes[k], cspecs[k], ctx), dtype=dt, device=dev)
        for k in shapes}
    f_l = cache["cross_k"].shape[2]
    if f_l != frames:
        off = distributed.axis_index(ctx.model_group) * f_l
        enc_out = enc_out[:, off:off + f_l]
    for i, (blk, bs) in enumerate(zip(
            _blocks(_top(params), "dec_blocks", cfg),
            _stack_specs(specs, "dec_blocks", cfg))):
        xattn = blk["xattn"] if bs is None else rules.gather_tree(
            blk["xattn"], bs["xattn"], ctx)
        k, v = L.cross_kv(xattn, enc_out, cfg)
        cache["cross_k"][i] = k
        cache["cross_v"][i] = v
    return cache


@torch.no_grad()
def decode_step(params, token: Tensor, cache: dict[str, Tensor],
                pos: Tensor, cfg: ArchConfig, ctx=None,
                max_len: int | None = None, frames: int | None = None
                ) -> tuple[Tensor, dict[str, Tensor]]:
    """One decoder token.  token: (B, 1) ids; pos: (B,) positions.
    Returns (h (B, 1, d), cache): each layer's self K/V written at ``pos``
    IN PLACE (the same dict returned; the reference returns a new one),
    the cross K/V read whole, in fp32, by ``layers.attn_decode`` with
    ``update_cache=False``.

    On a serving mesh ``params`` is an ``EncDec`` of the rank's shards,
    ``token`` and ``pos`` its rows and ``cache`` its blocks
    (``init_dec_cache``); ``max_len`` and ``frames`` are the self and
    cross caches' whole lengths (needed at tp > 1: they tell a rank's
    range from a whole sequence).  The self attention runs over the
    rank's heads against its range of the self cache, the cross attention
    every head against its range of the frames, each merged over
    ``model`` where its sequence is split (the module docstring)."""
    specs = _mesh_specs(params, ctx)
    top = _top(params)
    b = token.shape[0]
    own_group = cross_group = None
    if specs is not None and ctx.tp > 1:
        if rules.seq_split(ctx, cache["self_k"].shape[2], max_len,
                           "the decoder's self caches (max_len=)") > 1:
            own_group = ctx.model_group
        if rules.seq_split(ctx, cache["cross_k"].shape[2], frames,
                           "the decoder's cross caches (frames=)") > 1:
            cross_group = ctx.model_group
    x = _dec_embed(top, token, cfg, ctx, specs)
    x = x + top["dec_pos"]["table"][pos][:, None].to(x.dtype)
    # every frame is valid: the last whole position
    n_frames = cache["cross_k"].shape[2] if frames is None else frames
    every = torch.full((b,), n_frames - 1, dtype=torch.long,
                       device=token.device)
    for i, (blk, bs) in enumerate(zip(_blocks(top, "dec_blocks", cfg),
                                      _stack_specs(specs, "dec_blocks",
                                                   cfg))):
        blk, group = _gathered(blk, ctx, bs)
        h = L.apply_norm(blk["norm1"], x, cfg)
        y, _, _ = L.attn_decode(blk["attn"], h, cache["self_k"][i],
                                cache["self_v"][i], pos, cfg, rope_on=False,
                                group=group, cache_group=own_group)
        x = x + y
        hx = L.apply_norm(blk["norm_x"], x, cfg)
        # whole weights on every rank (the module docstring)
        y2, _, _ = L.attn_decode(blk["xattn"], hx, cache["cross_k"][i],
                                 cache["cross_v"][i], every, cfg,
                                 update_cache=False, rope_on=False,
                                 cache_group=cross_group)
        x = _mlp(blk, x + y2, cfg, group)
    return L.apply_norm(top["dec_norm"], x, cfg), cache
