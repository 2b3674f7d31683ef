"""Decoder-only LM of the port (``repro.models.transformer``): the dense,
MoE, SSM and hybrid families' forward, caches, prefill and one-token
decode, with MLA attention and the multi-token-prediction trunk
(deepseek-v3-671b).

Layers are grouped into homogeneous *segments* (consecutive layers of the
same mixer + ffn kind: ``attn+mlp``, ``attn+moe``, ``mamba+none``,
``mamba+mlp``, ``mamba+moe``) and each segment's params are stacked on a
leading layer axis, as in the reference, so converted params and caches
compare like with like: params ``{"embed": {"table"}, "final_norm":
{...}, "head": {"w"}, "segments": [stacked layer dicts]}`` (and
``"mtp"``, one unstacked ``attn+mlp`` block with its projection and norms,
where ``cfg.mtp``) and caches per segment ``{"k", "v"}`` of ``(count, B,
max_len, KV, hd)`` (attention), one latent tensor ``(count, B, max_len,
kv_lora_rank + qk_rope_dim)`` (MLA attention) or ``{"conv": (count, B,
K-1, d_inner), "ssm": (count, B, d_inner, N) fp32}`` (mamba).  The
reference scans a segment with ``lax.scan``; here a Python loop runs its
layers, each a view of the stacked tensors.

Training holds an LM's tree (any of the four families) as a
``StackedLM`` module whose layers are parameters of their own, views of
the stacked tensors: autograd then gives each layer its own gradient (the
gradient of a layer that indexes a stacked parameter would be a
zero-filled tensor of the whole stack, per layer and step).  Every
function here takes either form.  With ``cfg.remat`` set and grad enabled,
``hidden_states`` runs each layer under ``torch.utils.checkpoint``
(non-reentrant), as the reference rematerializes each layer's body with
``jax.checkpoint``: a layer keeps its input for the backward and runs its
forward again there.  With ``cfg.learned_pos`` RoPE is off and a tree's
``pos_embed`` table, where it has one, is added to the embeddings, as in
the reference (whose ``init_lm`` draws none).  The encoder-decoder family
is ``models/encdec.py``.

On a ``(data, model)`` mesh (``sharding/rules.py``) a ``StackedLM`` of any
of the four families holds this rank's shard of every parameter by the
reference's rules (``shard_params`` of ``train/step.py`` sets its
``param_specs``), and ``hidden_states(..., ctx)`` runs each layer on
``rules.compute_view`` of its shards, gathered inside the layer's remat
region so a recompute gathers again: whole in ``pure_fsdp`` (the rank's
own batch rows), the Megatron slices in ``tp_fsdp`` (``layers``' TP
attention and MLP and ``mla``'s head-parallel MLA over the model group,
``mamba``'s channel-parallel block, ``moe``'s experts over the model
group, the embedding vocab-parallel).  With ``ctx.seq_residuals`` (the
expert configs') the residual stream between the layers is this rank's
S-shard, (B, S / tp, d), wherever tp divides S (``rules.seq_sharded``,
the reference's ``fit_spec`` of its ``"bO."`` spec): norms run on the
shard, each block all-gathers S on entry and reduce-scatters its output
over S, the embedding's lookup is reduce-scattered over S, and h is
gathered whole after the final norm (``distributed.all_gather_replicated``),
as the reference returns it.  ``mtp_hidden``'s S - 1 rows take the same
rule on their own.

Serving on a mesh (``rules.ctx_for_serve``: tp mode, the parameters
replicated over ``data``, or tp_fsdp where the config sets
``serve_fsdp``, its F leaves gathered over ``data`` per layer; every
family here) takes a rank's sharded ``StackedLM`` and its rows of the
batch: ``init_cache``, ``prefill`` and ``decode_step`` lay the caches out
as the reference's ``init_cache`` constrains them (``cache_specs``): K/V
and MLA's latent rows with the sequence over ``model`` where tp divides
``max_len`` (``rules.seq_shards``; ``decode_step`` takes ``max_len`` to
tell it), the mamba window and state with their channels over
``model``.  The prefill runs each attention layer over the rank's heads
and keeps the rank's sequence range of every KV head (of the latent
rows, which every rank projects whole); the decode gathers the step's
q / k / v heads (MLA's absorbed queries), attends each rank's range and
merges the ranges' softmax over ``model``; a mamba layer runs
channel-parallel, its ``in_proj`` channel view built once per parameter
(``_in_proj_view``), not per step; a MoE layer dispatches to the rank's
experts (``moe.apply_moe``), its one reduction over ``model`` joined by
the shared experts' partial sums.

Full-sequence attention (``hidden_states``, ``prefill``, ``mtp_hidden``;
GQA and MLA's expanded form alike) goes through
``kernels.ops.flash_attention``: the CUDA kernels for CUDA tensors (under
autograd with their backward kernel), the plain version for CPU tensors.
Decode attends with plain tensor ops and writes the new token's K/V (or
MLA latent row) into the caches in place; a mamba layer's decode returns a
new state instead (``models/mamba.py``), so a step repeated on the same
caches gives the same result.
"""
from __future__ import annotations

import torch
import torch._dynamo  # noqa: F401  (why: models/mamba.py)
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core import distributed
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.sharding import rules
from repro_torch.utils.misc import resolve_device

Tensor = torch.Tensor
Params = dict

#: the families this module serves
LM_FAMILIES = ("dense", "moe", "ssm", "hybrid")



def require_ported(cfg: ArchConfig) -> None:
    """Raise for a config this module does not run: the decoder LMs are
    its families; the encoder-decoder family has a module of its own."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"'{cfg.name}' is an encoder-decoder (family 'encdec'): "
            "models/encdec.py runs it, not the decoder LM of "
            "models/transformer.py")
    if cfg.family not in LM_FAMILIES:
        raise NotImplementedError(
            f"'{cfg.name}' (family '{cfg.family}') is not a decoder LM: "
            f"this module runs the {', '.join(LM_FAMILIES)} families")


def cache_kv_heads(cfg: ArchConfig, tp: int = 1) -> int:
    """KV heads stored in decode caches: the true count for GQA, padded
    only for MHA, where padded q heads need 1:1 kv."""
    nh_p, _ = L.padded_heads(cfg, tp)
    if cfg.n_kv_heads == cfg.n_heads:
        return nh_p
    return cfg.n_kv_heads


def segments_of(cfg: ArchConfig) -> list[tuple[str, int]]:
    """[(kind, n_layers), ...] with consecutive same-kind layers merged."""
    segs: list[tuple[str, int]] = []
    for kind in cfg.layer_kinds():
        if segs and segs[-1][0] == kind:
            segs[-1] = (kind, segs[-1][1] + 1)
        else:
            segs.append((kind, 1))
    return segs


def padded_vocab(cfg: ArchConfig, tp: int = 1) -> int:
    return -(-cfg.vocab_size // tp) * tp


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _layer(seg_p: Params, i: int) -> Params:
    """Layer i of a stacked segment: views, so in-place writes reach it."""
    return _map(lambda t: t[i], seg_p)


class _Tree(nn.Module):
    """A nested dict of tensors as a module: each dict a submodule, each
    tensor a parameter (the same storage), in the dict's key order."""

    def __init__(self, tree: Params):
        super().__init__()
        self._keys = list(tree)
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, _Tree(val))
            else:
                self.register_parameter(key, nn.Parameter(val))

    def tree(self, leaf=None, prefix: str = "") -> Params:
        """The nested dict of parameters, or of ``leaf(name, parameter)``
        with the parameter's full name ``prefix + key``."""
        out = {}
        for key in self._keys:
            val = getattr(self, key)
            if isinstance(val, _Tree):
                out[key] = val.tree(leaf, f"{prefix}{key}.")
            else:
                out[key] = val if leaf is None else leaf(prefix + key, val)
        return out


class StackedLM(nn.Module):
    """An LM's parameters as a module, for training (the dense, moe, ssm
    and hybrid families).

    ``tree`` is ``init_lm``'s (or ``convert.lm_params_from_jax``'s) stacked
    tree; each layer of a segment becomes a submodule whose parameters are
    views of the stacked tensors, so nothing is copied; the ``mtp`` subtree
    (unstacked) is one submodule beside them.  Without a tree
    the parameters are allocated (``torch.empty``; on the ``meta`` device
    nothing at all).  Parameter names follow the tree: ``embed.table``,
    ``final_norm.scale``, ``head.w``, ``segments.<s>.<layer>.attn.wq``...
    ``convert`` stacks them back into the reference's layout."""

    #: {name: spec} of a mesh rank's shards (``train.step.shard_params``);
    #: None: every parameter whole
    param_specs: dict | None = None

    def __init__(self, cfg: ArchConfig, device: str | torch.device,
                 tree: Params | None = None, tp: int = 1, ctx=None):
        super().__init__()
        require_ported(cfg)
        if tree is None:
            dev = torch.device(device)
            tree = _map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device=dev),
                        init_lm(None, cfg, "meta", tp, ctx=ctx))
        self.counts = [count for _, count in segments_of(cfg)]
        self.embed = _Tree(tree["embed"])
        if "pos_embed" in tree:
            self.pos_embed = _Tree(tree["pos_embed"])
        self.final_norm = _Tree(tree["final_norm"])
        if "head" in tree:
            self.head = _Tree(tree["head"])
        self.segments = nn.ModuleList(
            nn.ModuleList(_Tree(_layer(seg, i)) for i in range(count))
            for seg, count in zip(tree["segments"], self.counts))
        if "mtp" in tree:
            self.mtp = _Tree(tree["mtp"])

    def tree(self, leaf=None) -> Params:
        """The parameters as the reference's tree, each segment a list of
        per-layer dicts; with ``leaf``, ``leaf(name, parameter)`` in each
        parameter's place."""
        out = {key: getattr(self, key).tree(leaf, f"{key}.")
               for key in ("embed", "final_norm", "pos_embed", "head")
               if hasattr(self, key)}
        out["segments"] = [[layer.tree(leaf, f"segments.{s}.{i}.")
                            for i, layer in enumerate(seg)]
                           for s, seg in enumerate(self.segments)]
        if hasattr(self, "mtp"):
            out["mtp"] = self.mtp.tree(leaf, "mtp.")
        return out

    def spec_tree(self) -> Params | None:
        """``tree()`` with each parameter's spec in its place (None when
        the parameters are whole)."""
        if self.param_specs is None:
            return None
        return self.tree(lambda name, _: self.param_specs[name])


def _top(params) -> Params:
    """The embed / final_norm / head (/ mtp) entries of either form."""
    return params.tree() if isinstance(params, StackedLM) else params


def _layers_of(params, cfg: ArchConfig) -> list[list[Params]]:
    """Per segment, its layers' param dicts: a ``StackedLM``'s own, or
    views of a stacked tree."""
    if isinstance(params, StackedLM):
        return params.tree()["segments"]
    return [[_layer(seg_p, i) for i in range(count)]
            for (_, count), seg_p in zip(segments_of(cfg),
                                         params["segments"])]


# --- init --------------------------------------------------------------------


def _init_layer(gen: torch.Generator, kind: str, cfg: ArchConfig,
                device: torch.device, tp: int = 1) -> Params:
    mixer, ffn = kind.split("+")
    p: Params = {"norm1": L.init_norm(cfg, device)}
    if mixer == "attn":
        p["attn"] = (MLA.init_mla(gen, cfg, device, tp) if cfg.mla
                     else L.init_attention(gen, cfg, device, tp))
    else:
        p["mamba"] = M.init_mamba_full(gen, cfg, device)
    if ffn != "none":
        p["norm2"] = L.init_norm(cfg, device)
        if ffn == "moe":
            p["moe"] = MOE.init_moe(gen, cfg, device)
        else:
            p["mlp"] = L.init_mlp(gen, cfg, device)
    return p


def _stacked(count: int, make) -> Params:
    """``count`` layers from ``make()``, drawn one at a time into stacked
    tensors (no second copy of the stack is ever held; a one-layer stack
    is its layer's tensors with a leading axis, no copy at all)."""
    first = make()
    if count == 1:
        return _map(lambda t: t[None], first)
    stacked = _map(lambda t: torch.empty((count, *t.shape), dtype=t.dtype,
                                         device=t.device), first)
    for i in range(count):
        _copy_into(_layer(stacked, i), first if i == 0 else make())
    return stacked


def _init_segment(gen: torch.Generator, kind: str, count: int,
                  cfg: ArchConfig, device: torch.device, tp: int,
                  keep=None, prefix: str = "") -> Params:
    """A segment's stacked layers; ``keep(name, tensor)``, where given,
    takes each layer's leaves as soon as the layer is drawn (names
    ``<prefix><layer>.<path>``)."""
    i = iter(range(count))

    def make():
        layer = _init_layer(gen, kind, cfg, device, tp)
        return layer if keep is None else _keep_tree(
            keep, f"{prefix}{next(i)}.", layer)

    return _stacked(count, make)


def _keep_tree(keep, prefix: str, tree: Params) -> Params:
    """``keep(prefix + path, leaf)`` in place of each leaf of ``tree``."""
    return {k: _keep_tree(keep, f"{prefix}{k}.", v) if isinstance(v, dict)
            else keep(prefix + k, v) for k, v in tree.items()}


def _copy_into(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


def init_lm(gen: torch.Generator | None, cfg: ArchConfig,
            device: str | torch.device | None = None, tp: int = 1,
            ctx=None, shard: bool = False) -> Params:
    """Random weights from ``gen`` on ``device`` (the card unless
    ``device="cpu"``).  Heads are padded to a multiple of ``tp`` and the
    vocab to ``tp`` rows; with a mesh ``ctx`` the heads to its backbone's
    TP degree and the vocab to its head's (``ctx.tp_backbone``,
    ``ctx.tp``: 1 and the model axis in pure_fsdp), as the reference's
    ``init_lm``.  Vocab rows at and after ``vocab_size`` are zero, as in
    the reference.  On the ``meta`` device nothing is drawn (``gen`` may
    be None): the tree's shapes and dtypes.  With ``shard`` (and a mesh
    ``ctx``) the same weights are drawn, and each leaf is cut to this
    rank's shard (``rules.spec_for``) as soon as its layer is drawn, so a
    rank never holds more than one layer whole."""
    require_ported(cfg)
    keep = None
    if shard and rules.on_mesh(ctx):
        def keep(name, t):
            return rules.shard_by_spec(
                t, rules.spec_for(name, t.shape, ctx), ctx)
    dev = resolve_device(device)
    nvp = padded_vocab(cfg, ctx.tp if rules.on_mesh(ctx) else tp)
    if rules.on_mesh(ctx):
        tp = ctx.tp_backbone
    pd = L._pdtype(cfg)
    emb = L.dense_init(gen, (nvp, cfg.d_model), pd, dev, scale=0.02)
    emb[cfg.vocab_size:] = 0
    params: Params = {"embed": {"table": emb},
                      "final_norm": L.init_norm(cfg, dev)}
    if not cfg.tie_embeddings:
        head = L.dense_init(gen, (nvp, cfg.d_model), pd, dev, scale=0.02)
        head[cfg.vocab_size:] = 0
        params["head"] = {"w": head}
    if keep is not None:
        params = _keep_tree(keep, "", params)
        emb = head = None  # only the tables' shards are kept
    params["segments"] = [
        _init_segment(gen, kind, count, cfg, dev, tp, keep,
                      f"segments.{s}.")
        for s, (kind, count) in enumerate(segments_of(cfg))]
    if cfg.mtp:
        mtp = {
            "proj": L.dense_init(gen, (2 * cfg.d_model, cfg.d_model), pd,
                                 dev),
            "norm_h": L.init_norm(cfg, dev),
            "norm_e": L.init_norm(cfg, dev),
            "block": _init_layer(gen, "attn+mlp", cfg, dev, tp),
            "final_norm": L.init_norm(cfg, dev),
        }
        params["mtp"] = mtp if keep is None else _keep_tree(keep, "mtp.",
                                                            mtp)
    return params


# --- apply -------------------------------------------------------------------


def _apply_ffn(ffn: str, p: Params, x: Tensor, cfg: ArchConfig,
               group=None, ctx=None, seq: bool = False,
               mesh_aux: bool = True, gather_rows: bool = False
               ) -> tuple[Tensor, Tensor | None]:
    """x + the layer's FFN (MLP, MoE or none) of norm2(x), and the MoE's
    aux loss (None for the others); on a mesh (``ctx``) the MLP
    tensor-parallel over ``group`` and the MoE's experts over the model
    group, with ``seq`` on S-shards (``mesh_aux``, ``gather_rows``:
    ``moe.apply_moe``'s)."""
    if ffn == "none":
        return x, None
    h = L.apply_norm(p["norm2"], x, cfg)
    if ffn == "moe":
        y, aux = MOE.apply_moe(p["moe"], h, cfg, ctx, seq, mesh_aux,
                               gather_rows)
        return x + y, aux
    return x + L.apply_mlp(p["mlp"], h, cfg, group=group, seq=seq), None


def _apply_layer(kind: str, p: Params, x: Tensor, positions: Tensor,
                 cfg: ArchConfig, ctx=None, specs: Params | None = None,
                 seq: bool = False) -> tuple[Tensor, Tensor | None]:
    """One layer; on a mesh (``specs``, the layer's) its shards are
    gathered here first (``rules.compute_view``; a mamba block's by
    ``mamba.mesh_view``) and the attention (GQA or MLA), MLP, MoE and
    mamba block run tensor-parallel over ``rules.tp_group(ctx)``; with
    ``seq`` x is this rank's S-shard and positions the whole sequence's."""
    mixer, ffn = kind.split("+")
    group = None
    if specs is not None:
        group = rules.tp_group(ctx)
        p = {k: M.mesh_view(v, specs[k], ctx, group) if k == "mamba"
             else rules.gather_tree(v, specs[k], ctx) for k, v in p.items()}
    else:
        ctx = None
    h = L.apply_norm(p["norm1"], x, cfg)
    if mixer == "attn" and cfg.mla:
        x = x + MLA.mla_forward(p["attn"], h, positions, cfg, group=group,
                                seq=seq)
    elif mixer == "attn":
        x = x + L.attn_forward(p["attn"], h, positions, cfg, group=group,
                               seq=seq)
    else:
        x = x + M.apply_mamba(p["mamba"], h, cfg, group=group, seq=seq)
    return _apply_ffn(ffn, p, x, cfg, group, ctx, seq)


def _positions(b: int, s: int, device: torch.device) -> Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def _embed(top: Params, tokens: Tensor, cfg: ArchConfig,
           pos: Tensor | None = None, ctx=None,
           specs: Params | None = None, seq: bool = False) -> Tensor:
    """The tokens' embeddings, plus the learned position table's rows
    where ``cfg.learned_pos`` and the tree has one: positions 0..S-1, or
    ``pos`` (B,) for a one-token step.  On a mesh (``specs``; no position
    table) the table's ``compute_view``: vocab-parallel under TP (with
    ``seq`` this rank's S-shard of the rows), whole in pure_fsdp."""
    if specs is not None:
        spec = specs["embed"]["table"]
        return L.apply_embed(
            {"table": rules.compute_view(top["embed"]["table"], spec, ctx)},
            tokens, cfg, rules.vocab_group(spec, ctx), seq)
    x = L.apply_embed(top["embed"], tokens, cfg)
    if cfg.learned_pos and "pos_embed" in top:
        table = top["pos_embed"]["table"]
        rows = table[pos][:, None] if pos is not None \
            else table[:tokens.shape[1]][None]
        x = x + rows.to(x.dtype)
    return x


def hidden_states(params, tokens: Tensor, cfg: ArchConfig,
                  ctx=None) -> tuple[Tensor, Tensor]:
    """Backbone forward: tokens (B, S) -> (h (B, S, d), aux_loss: the MoE
    layers' summed, 0 without them).  ``params``: the stacked tree or a
    ``StackedLM``; differentiable.  With ``cfg.remat`` and grad enabled
    each layer is checkpointed: its forward runs again in the backward.

    On a mesh ``params`` is a sharded ``StackedLM`` and ``tokens`` this
    rank's batch rows; h is its rows' states, whole and alike over the
    model group under TP (gathered over S after the final norm where the
    residual stream is S-sharded)."""
    require_ported(cfg)
    specs = _mesh_specs(params, ctx)
    b, s = tokens.shape
    seq = rules.seq_sharded(ctx, s)
    top = _top(params)
    x = _embed(top, tokens, cfg, ctx=ctx, specs=specs, seq=seq)
    positions = _positions(b, s, tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    layer_specs = specs["segments"] if specs else [
        [None] * count for _, count in segments_of(cfg)]
    for (kind, _), layers, lspecs in zip(
            segments_of(cfg), _layers_of(params, cfg), layer_specs):
        for lp, ls in zip(layers, lspecs):
            if remat:
                x, a = torch.utils.checkpoint.checkpoint(
                    _apply_layer, kind, lp, x, positions, cfg, ctx, ls, seq,
                    use_reentrant=False)
            else:
                x, a = _apply_layer(kind, lp, x, positions, cfg, ctx, ls,
                                    seq)
            if a is not None:
                aux = aux + a
    x = L.apply_norm(top["final_norm"], x, cfg)
    if seq:
        x = distributed.all_gather_replicated(x, ctx.model_group, dim=1)
    return x, aux


def _mesh_specs(params, ctx) -> Params | None:
    """The spec tree of a mesh rank's ``StackedLM`` (None off a mesh)."""
    if not rules.on_mesh(ctx):
        return None
    specs = params.spec_tree() if isinstance(params, StackedLM) else None
    if specs is None:
        raise ValueError("on a mesh the LM takes a StackedLM of the rank's "
                         "shards (train.step.shard_params)")
    return specs


def residual_rows(name: str, s: int) -> int:
    """The rows of the residual stream a parameter ``name`` of the LM acts
    on at sequence length ``s``: the mtp trunk's S - 1, the rest's S."""
    return s - 1 if name.startswith("mtp.") else s


def mtp_hidden(params, h: Tensor, tokens: Tensor, cfg: ArchConfig,
               ctx=None) -> Tensor:
    """DeepSeek-style multi-token-prediction trunk: h_t (the backbone's
    final hidden state) with the embedding of token t+1, to predict token
    t+2.  h: (B, S, d); tokens: (B, S) -> (B, S-1, d); differentiable (its
    block is never rematerialized, as in the reference).  On a mesh its
    block runs as the backbone's layers do, over the S - 1 rows'
    own ``rules.seq_sharded`` rule (h is whole: its rows are split here
    where the rule shards them, and the result gathered back)."""
    specs = _mesh_specs(params, ctx)
    top = _top(params)
    p = top["mtp"]
    b, s = tokens.shape
    seq = rules.seq_sharded(ctx, s - 1)
    sp = specs["mtp"] if specs else None
    emb_next = (_embed(top, tokens[:, 1:], cfg, ctx=ctx, specs=specs,
                       seq=seq) if specs
                else L.apply_embed(top["embed"], tokens[:, 1:], cfg))
    h_in = h[:, :-1]
    if seq:
        h_in = distributed.split_tiled(h_in, ctx.model_group, dim=1)
    if specs is not None:
        p = {k: p[k] if k == "block" else rules.gather_tree(p[k], sp[k], ctx)
             for k in p}
    hh = L.apply_norm(p["norm_h"], h_in, cfg)
    ee = L.apply_norm(p["norm_e"], emb_next, cfg)
    x = torch.cat([hh, ee], dim=-1) @ p["proj"].to(h.dtype)
    positions = _positions(b, s - 1, tokens.device)
    x, _ = _apply_layer("attn+mlp", p["block"], x, positions, cfg, ctx,
                        sp["block"] if sp else None, seq)
    x = L.apply_norm(p["final_norm"], x, cfg)
    if seq:
        x = distributed.all_gather_replicated(x, ctx.model_group, dim=1)
    return x


# --- caches / serving --------------------------------------------------------

def _serve_specs(params, ctx) -> Params | None:
    """The spec tree of a rank's ``StackedLM`` on a serving mesh (None off
    a mesh), after refusing a ctx that is not a serving one."""
    if not rules.on_mesh(ctx):
        return None
    if ctx.mode == "pure_fsdp" or ctx.seq_residuals:
        raise ValueError(
            f"serving takes the ctx of rules.ctx_for_serve (tp, or tp_fsdp "
            f"without seq_residuals), not mode {ctx.mode} with "
            f"seq_residuals={ctx.seq_residuals}")
    return _mesh_specs(params, ctx)


def _in_proj_view(params: StackedLM, name: str, p: Tensor, spec, ctx,
                  group) -> Tensor:
    """A mamba layer's ``in_proj`` cut to this rank's channels
    (``mamba.mesh_view``), built once per parameter and kept on the
    module: rebuilt only when the parameter is replaced or written in
    place (its version counter moves)."""
    views = params.__dict__.setdefault("_serve_in_proj", {})
    key = (id(ctx.mesh), p._version, p.data_ptr())
    got = views.get(name)
    if got is None or got[0] != key:
        view = M.mesh_view({"in_proj": p}, {"in_proj": spec}, ctx,
                           group)["in_proj"]
        views[name] = got = (key, view)
    return got[1]


def _serve_layer(params, s: int, i: int, lp: Params, specs: Params | None,
                 ctx, group) -> Params:
    """Layer i of segment s as serving computes on it: off a mesh its own
    tensors; on a mesh ``rules.compute_view`` of each shard (nothing to
    gather in tp mode; in tp_fsdp each F leaf, the experts' ``Fd`` dims
    included, all-gathered over ``data``) and a mamba block's ``in_proj``
    channel view from ``_in_proj_view``."""
    if specs is None:
        return lp
    ls = specs["segments"][s][i]
    out = {k: rules.gather_tree(v, ls[k], ctx) for k, v in lp.items()
           if k != "mamba"}
    if "mamba" in lp:
        mp, ms = lp["mamba"], ls["mamba"]
        out["mamba"] = {
            k: _in_proj_view(params, f"segments.{s}.{i}.mamba.in_proj", v,
                             ms[k], ctx, group)
            if k == "in_proj" and group is not None
            else rules.compute_view(v, ms[k], ctx)
            for k, v in mp.items()}
    return out


def cache_specs(cfg: ArchConfig, batch: int, max_len: int, ctx=None
                ) -> list:
    """Per segment, the spec of each cache leaf of a WHOLE batch of
    ``batch`` and ``max_len`` positions (``rules.cache_spec``: the
    reference's ``init_cache`` constraints, fitted): ``{"k", "v"}``, one
    latent spec, or ``{"conv", "ssm"}``."""
    out = []
    for kind, shape in _cache_shapes(cfg, batch, max_len, _cache_tp(ctx)):
        if kind == "latent":
            out.append(rules.cache_spec("latent", shape, ctx))
        else:
            out.append({k: rules.cache_spec(k, sh, ctx)
                        for k, sh in shape.items()})
    return out


def _cache_tp(ctx) -> int:
    """The backbone's TP degree the caches' KV heads are padded for (an
    MHA config's; a GQA cache keeps the true count)."""
    return ctx.tp_backbone if rules.on_mesh(ctx) else 1


def _cache_shapes(cfg: ArchConfig, batch: int, max_len: int,
                  tp: int = 1) -> list:
    """Per segment (its cache kind, the whole shapes of its leaves)."""
    nkv = cache_kv_heads(cfg, tp)
    hd = cfg.resolved_head_dim
    out = []
    for kind, count in segments_of(cfg):
        if kind.startswith("attn") and cfg.mla:
            out.append(("latent", (count, batch, max_len,
                                   cfg.kv_lora_rank + cfg.qk_rope_dim)))
        elif kind.startswith("attn"):
            kv = (count, batch, max_len, nkv, hd)
            out.append(("kv", {"k": kv, "v": kv}))
        else:
            out.append(("mamba", {
                "conv": (count, batch, cfg.ssm_conv - 1, cfg.d_inner),
                "ssm": (count, batch, cfg.d_inner, cfg.ssm_state)}))
    return out


def init_cache(cfg: ArchConfig, batch: int, max_len: int, ctx=None,
               dtype: torch.dtype | None = None,
               device: str | torch.device | None = None) -> list[Params]:
    """Per-segment stacked zero caches sized for max_len tokens, on
    ``device`` (the card unless ``device="cpu"``): K/V in ``dtype`` for
    attention (one latent tensor of kv_lora_rank + qk_rope_dim a token for
    MLA), the conv window in ``dtype`` and the fp32 state for mamba.  On a
    serving mesh ``batch`` is the whole batch and each leaf this rank's
    block of it by ``cache_specs``: K/V its data rows and sequence range,
    the mamba leaves its data rows and channels."""
    require_ported(cfg)
    dev = resolve_device(device)
    dt = dtype or L._dtype(cfg)
    caches = []
    for (kind, shapes), spec in zip(
            _cache_shapes(cfg, batch, max_len, _cache_tp(ctx)),
            cache_specs(cfg, batch, max_len, ctx)):
        if kind == "latent":
            caches.append(torch.zeros(rules.local_shape(shapes, spec, ctx),
                                      dtype=dt, device=dev))
            continue
        caches.append({k: torch.zeros(rules.local_shape(sh, spec[k], ctx),
                                      dtype=torch.float32 if k == "ssm"
                                      else dt, device=dev)
                       for k, sh in shapes.items()})
    return caches


def _kv_seq_shards(cfg: ArchConfig, caches: list[Params], ctx,
                   max_len: int | None) -> int:
    """The model ranks ``decode_step``'s attention caches (K/V or MLA's
    latent rows) split their sequence over (``rules.seq_shards`` of their
    whole length ``max_len``); 1 off a mesh, at tp 1 and without attention
    caches."""
    attn = [c["k"] if isinstance(c, dict) else c
            for (kind, _), c in zip(segments_of(cfg), caches)
            if kind.startswith("attn")]
    if not rules.on_mesh(ctx) or ctx.tp == 1 or not attn:
        return 1
    return rules.seq_split(ctx, attn[0].shape[2], max_len,
                           "decode_step's attention caches (max_len=)")


@torch.no_grad()
def decode_step(params, token: Tensor, caches: list[Params],
                pos: Tensor, cfg: ArchConfig, ctx=None,
                max_len: int | None = None, batch: int | None = None
                ) -> tuple[Tensor, list[Params]]:
    """One-token decode.  token: (B, 1) ids; pos: (B,).  Returns (h (B, 1,
    d), caches): attention segments' K/V (MLA's latent rows) written at
    ``pos`` IN PLACE (the same dicts or tensors returned; the given list
    itself without mamba segments), mamba segments' states in new tensors
    (the given ones untouched).

    On a serving mesh (``ctx``: ``rules.ctx_for_serve``'s) ``params`` is a
    rank's sharded ``StackedLM``, ``token`` and ``pos`` its rows and
    ``caches`` its blocks (``init_cache``) and ``max_len`` their whole
    length (needed where they hold attention and tp > 1): the embedding
    vocab-parallel, each attention layer over the sequence-sharded cache
    (``layers.attn_decode``; MLA's ``mla.mla_decode`` over its latent
    rows), each mamba layer channel-parallel (``mamba.mamba_decode``), the
    MLP Megatron's, a MoE layer over the rank's experts (``batch``: the
    whole batch its rows are of, ``moe.moe_rows``); h is whole."""
    require_ported(cfg)
    specs = _serve_specs(params, ctx)
    group = rules.tp_group(ctx) if specs is not None else None
    mesh_ctx = ctx if specs is not None else None
    gather = _moe_rows(cfg, mesh_ctx, token.shape[0], batch)
    split = _kv_seq_shards(cfg, caches, ctx, max_len) > 1
    cache_group = group if split else None
    top = _top(params)
    x = _embed(top, token, cfg, pos, ctx=ctx, specs=specs)
    new_caches = []
    for s, ((kind, _), layers, cache) in enumerate(zip(
            segments_of(cfg), _layers_of(params, cfg), caches)):
        mixer, ffn = kind.split("+")
        if mixer == "mamba":
            new = {k: torch.empty_like(v) for k, v in cache.items()}
        for i, lp in enumerate(layers):
            lp = _serve_layer(params, s, i, lp, specs, ctx, group)
            h = L.apply_norm(lp["norm1"], x, cfg)
            if mixer == "attn" and cfg.mla:
                y, _ = MLA.mla_decode(lp["attn"], h, cache[i], pos, cfg,
                                      group=group, cache_group=cache_group)
            elif mixer == "attn":
                y, _, _ = L.attn_decode(
                    lp["attn"], h, cache["k"][i], cache["v"][i], pos, cfg,
                    group=group, cache_group=cache_group)
            else:
                y, c = M.mamba_decode(lp["mamba"], h, _layer(cache, i), cfg,
                                      group)
                _copy_into(_layer(new, i), c)
            x, _ = _apply_ffn(ffn, lp, x + y, cfg, group, mesh_ctx,
                              mesh_aux=False, gather_rows=gather)
        new_caches.append(cache if mixer == "attn" else new)
    if all(n is c for n, c in zip(new_caches, caches)):
        new_caches = caches
    return L.apply_norm(top["final_norm"], x, cfg), new_caches


def _moe_rows(cfg: ArchConfig, ctx, rows: int, batch: int | None) -> bool:
    """``moe.moe_rows`` where the LM has experts (False without them or
    off a mesh)."""
    return bool(cfg.n_experts) and MOE.moe_rows(ctx, rows, batch)


def _own_range(group, split: bool, s: int, s_len: int) -> tuple[int, int]:
    """(offset, rows) of a prompt of ``s`` positions that a rank's cache
    of ``s_len`` positions keeps: its range where the sequence is split
    over ``group``, else the start of the whole."""
    off = distributed.axis_index(group) * s_len if split else 0
    return off, min(max(s - off, 0), s_len)


@torch.no_grad()
def prefill(params, tokens: Tensor, cfg: ArchConfig, ctx=None,
            max_len: int | None = None, batch: int | None = None
            ) -> tuple[Tensor, list[Params]]:
    """Full-sequence prefill: (h (B, S, d), caches filled to S and zero
    after it, of length ``max_len`` (default S)).  Every attention layer is
    one ``ops.flash_attention`` call (an MLA layer's cache its latent
    rows); a mamba layer's cache is its conv window and its state after
    the last token.

    On a serving mesh (``decode_step``) ``tokens`` are this rank's rows:
    each attention layer runs its own heads through the flash kernel, and
    its cache takes this rank's sequence range of every KV head (k and v
    all-gathered over the model group on the head dim in one call; an MLA
    layer's latent rows, which every rank projects whole); each mamba
    layer runs channel-parallel and keeps its channels' window and state;
    each MoE layer runs the rank's experts (``batch``: ``decode_step``'s);
    h is whole."""
    require_ported(cfg)
    specs = _serve_specs(params, ctx)
    group = rules.tp_group(ctx) if specs is not None else None
    mesh_ctx = ctx if specs is not None else None
    b, s = tokens.shape
    gather = _moe_rows(cfg, mesh_ctx, b, batch)
    max_len = max_len or s
    dt = L._dtype(cfg)
    top = _top(params)
    x = _embed(top, tokens, cfg, ctx=ctx, specs=specs)
    positions = _positions(b, s, tokens.device)
    # the whole batch these rows are a block of: b x dp, or b itself where
    # they are a whole batch dp does not divide; either gives this rank's
    # cache shapes
    caches = init_cache(cfg, b * ctx.dp if specs is not None else b,
                        max_len, ctx if specs is not None else None,
                        dtype=dt, device=tokens.device)
    nkv_c = cache_kv_heads(cfg, _cache_tp(ctx))
    split = rules.seq_shards(ctx, max_len) > 1
    for si, ((kind, _), layers, cache) in enumerate(zip(
            segments_of(cfg), _layers_of(params, cfg), caches)):
        mixer, ffn = kind.split("+")
        for i, lp in enumerate(layers):
            lp = _serve_layer(params, si, i, lp, specs, ctx, group)
            h = L.apply_norm(lp["norm1"], x, cfg)
            if mixer == "attn" and cfg.mla:
                y = MLA.mla_forward(lp["attn"], h, positions, cfg,
                                    group=group)
                lat = MLA.mla_latent_cache(lp["attn"], h, positions, cfg)
                off, n = _own_range(group, split, s, cache.shape[2])
                cache[i, :, :n] = lat[:, off:off + n].to(dt)
            elif mixer == "attn":
                y, k, v = L.attn_prefill(lp["attn"], h, positions, cfg,
                                         group=group)
                k, v = L.gather_heads([k, v], group)
                off, n = _own_range(group, split, s, cache["k"].shape[2])
                cache["k"][i, :, :n] = k[:, off:off + n, :nkv_c].to(dt)
                cache["v"][i, :, :n] = v[:, off:off + n, :nkv_c].to(dt)
            else:
                y, c = M.mamba_prefill(lp["mamba"], h, cfg, group=group)
                _copy_into(_layer(cache, i), c)
            x, _ = _apply_ffn(ffn, lp, x + y, cfg, group, mesh_ctx,
                              mesh_aux=False, gather_rows=gather)
    return L.apply_norm(top["final_norm"], x, cfg), caches
