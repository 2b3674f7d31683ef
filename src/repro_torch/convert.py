"""Carry weights and serving state from the JAX package into the port.

Both functions take plain numpy arrays (the JAX side converts with
``np.asarray``), so this module needs neither jax nor ``repro``:

  * ``params_from_jax`` — the reference's params, by family: the recsys
    dict (``{"embed": {"table"}, "head": {"w"}, "tower": {"w0", "b0",
    ...}}``) into the port's ``RecsysTower``, the lstm dict (``{"embed",
    "head", "lstm0": {"kernel", "recurrent", "bias"}, ...}``) into its
    ``LSTMLM``, the decoder LMs' ``init_lm`` tree (dense, moe, ssm,
    hybrid; MLA layers and the ``mtp`` subtree too) through
    ``lm_params_from_jax``, and the encoder-decoder's ``init_encdec``
    tree (``enc_blocks`` and ``dec_blocks`` stacked, both position
    tables).  Same layouts, so all copy.
  * ``lm_params_from_jax`` — the reference's LM params (nested dicts, each
    segment stacked on a leading layer axis) into the same tree of
    tensors, each leaf in its own dtype (the router, ``a_log``, ``d``,
    ``dt_bias`` and the norms fp32).
  * ``caches_from_jax`` — the reference's decode caches (per segment
    ``{"k", "v"}``, ``{"conv", "ssm"}`` or MLA's one latent tensor; the
    encoder-decoder's one dict ``{"self_k", "self_v", "cross_k",
    "cross_v"}``) into the port's.
  * ``index_from_jax`` — a reference ``RetrievalIndex`` or
    ``QuantizedRetrievalIndex``, field by field, into the port's (of a
    sharded one, a mesh rank's own shard).
  * ``lm_shards_from_jax`` — the reference's LM or encoder-decoder params
    onto a mesh rank's shards (a ``StackedLM`` or an ``EncDec``; the
    serving engine's on a mesh, in tp or tp_fsdp).
  * ``train_state_from_jax`` — a reference ``TrainState`` of a recsys,
    lstm, LM or encoder-decoder model (params, the ``chain(clip, adamw)``
    or ``chain(clip, adafactor)`` state, the sampler's carried state and
    the step) into
    the port's ``TrainState``, so both packages can take a step from one
    state.

And back, numpy out:

  * ``params_to_jax`` — a ``RecsysTower``, ``LSTMLM``, ``StackedLM`` or
    ``EncDec`` into the reference's param tree (recsys and lstm names
    split at their first ``_``; a ``StackedLM``'s layers stacked per
    segment, an ``EncDec``'s per block stack); a stacked tree leaf for
    leaf.
  * ``caches_to_jax`` — the port's decode caches as numpy (on a serving
    mesh each rank's blocks gathered; ``caches_from_jax(..., ctx=)`` cuts
    the reference's caches into them, by ``transformer.cache_specs``, an
    encoder-decoder's by ``encdec.cache_specs``).
  * ``train_state_to_jax`` — the port's ``TrainState`` into the four
    arguments ``train_state_from_jax`` takes.
  * On a mesh (a ``ShardCtx``), ``train_state_from_jax(..., ctx=)`` puts
    the reference's params and optimizer state onto this rank's shards by
    ``rules.param_specs_for`` (``shard_train_state``), and
    ``train_state_to_jax(state, ctx=)`` gathers them back
    (``gather_train_state``): both ways bitwise.  ``reference_tree`` gives
    the same tree with the port's own tensors as leaves (no copy; a
    ``StackedLM`` layer stack as a ``Stacked`` of its layers' tensors):
    what the checkpoint manager flattens into the reference's keys.
  * ``index_to_jax`` — a port index's fields as numpy (a sharded one
    gathered over its mesh's model group).

bf16 tensors cross as numpy's 2-byte void type (``|V2``), their raw bits:
what numpy writes for the reference's bf16 arrays in an ``.npz``.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import distributed
from repro_torch.core.samplers import SamplerState
from repro_torch.models import api, encdec
from repro_torch.models.encdec import STACKS as ENCDEC_STACKS
from repro_torch.models.encdec import EncDec
from repro_torch.models import transformer
from repro_torch.models.transformer import (
    LM_FAMILIES,
    StackedLM,
    require_ported,
    segments_of,
)
from repro_torch.optim import adafactor, adamw, chain, clip_by_global_norm
from repro_torch.optim.adafactor import stacks as adafactor_stacks
from repro_torch.serve.quantized_index import QuantizedRetrievalIndex
from repro_torch.serve.retrieval import RetrievalIndex
from repro_torch.sharding import rules
from repro_torch.train.step import TrainState
from repro_torch.utils.misc import resolve_device


def _flat_params(np_params: dict) -> dict:
    """Reference recsys or lstm param tree -> the port's parameter names:
    the path's keys joined by ``_`` (``embed.table`` -> ``embed_table``,
    ``tower.w0`` -> ``tower_w0``, ``lstm1.kernel`` -> ``lstm1_kernel``)."""
    flat = {}
    for key, val in np_params.items():
        if isinstance(val, dict):
            flat.update({f"{key}_{k}": v
                         for k, v in _flat_params(val).items()})
        else:
            flat[key] = val
    return flat


class Stacked:
    """Tensors the reference keeps stacked on a leading layer axis and the
    port holds apart (a ``StackedLM`` segment's layers, or their optimizer
    moments): a leaf of ``reference_tree``, stacked only when copied to the
    host (``host_copy``), so the card never holds a second copy."""

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype


def host_copy(t) -> np.ndarray:
    """A copy of a tensor (or number, or ``Stacked``) on the host: the
    caller's tensor may change in place afterwards (the optimizer updates
    params in place).  bf16 comes back as ``|V2``, its raw bits."""
    if isinstance(t, Stacked):
        return np.stack([host_copy(p) for p in t.parts])
    if not isinstance(t, torch.Tensor):
        return np.array(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return host_copy(t.view(torch.int16)).view(np.dtype("V2"))
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


def from_numpy(arr) -> torch.Tensor:
    """A host array as a tensor; a 2-byte void array (``|V2``, bf16's bits
    as numpy stores them) or an ``ml_dtypes`` bfloat16 one as bf16."""
    arr = np.array(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _map_tree(fn, tree):
    """``fn`` applied to every tensor of a tree of dicts, tuples and
    lists; ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return tree if tree is None else fn(tree)


def _set_path(tree, path, val) -> None:
    for key in path[:-1]:
        tree = tree[key] if isinstance(tree, list) else tree.setdefault(
            key, {})
    tree[path[-1]] = val


def _path(name: str, model: torch.nn.Module) -> tuple[list, int | None]:
    """Where a parameter name, or a stack key of the optimizer's state
    (``optim.adafactor.stacks``), sits in the reference's tree: (the path
    to the leaf, the layer's row of it or None).  A ``StackedLM``'s
    ``segments.<s>.<i>.<path>`` is row i of ``segments[s][path]``, its
    stack key ``segments.<s>.<path>`` the whole leaf; an ``EncDec``'s
    ``enc_blocks.<i>.<path>`` row i of ``enc_blocks[path]`` (and
    ``dec_blocks`` so), its stack key ``enc_blocks.<path>`` the whole
    leaf; a recsys or lstm name splits at its first ``_`` (their
    top-level keys hold none)."""
    if isinstance(model, EncDec):
        parts = name.split(".")
        if parts[0] in ENCDEC_STACKS and parts[1].isdigit():
            return [parts[0], *parts[2:]], int(parts[1])
        return parts, None
    if isinstance(model, StackedLM):
        parts = name.split(".")
        if parts[0] != "segments":
            return parts, None
        if parts[2].isdigit():
            return ["segments", int(parts[1]), *parts[3:]], int(parts[2])
        return ["segments", int(parts[1]), *parts[2:]], None
    top, _, rest = name.partition("_")
    return ([top, rest] if rest else [top]), None


def _to_reference(named: dict, model: torch.nn.Module) -> dict:
    """A dict keyed by ``model``'s parameter names (the parameters, a
    moment) or by stack keys (Adafactor's statistics) -> the reference's
    tree: each value at its path, a ``StackedLM`` segment's per-layer
    entries as one ``Stacked`` of the layers in order."""
    out: dict = ({"segments": [{} for _ in model.counts]}
                 if isinstance(model, StackedLM) else {})
    rows: dict = {}
    for name, val in named.items():
        path, i = _path(name, model)
        if i is None:
            _set_path(out, path, val)
        else:
            rows.setdefault(tuple(path), {})[i] = val
    for path, by_layer in rows.items():
        _set_path(out, path, Stacked(by_layer[i]
                                     for i in range(len(by_layer))))
    return out


def _from_reference(tree: dict, keys, model: torch.nn.Module) -> dict:
    """The inverse of ``_to_reference`` for the given keys: each key's
    value read at its path, a per-layer name's as its row of the stacked
    leaf (a ``Stacked``'s part, or a view of the tensor)."""
    out = {}
    for key in keys:
        path, i = _path(key, model)
        node = tree
        for k in path:
            node = node[k]
        if i is not None:
            node = node.parts[i] if isinstance(node, Stacked) else node[i]
        out[key] = node
    return out


def _module_of(state: TrainState) -> torch.nn.Module:
    modules = sorted({m.__name__ for m in api.PARAM_MODULES.values()})
    if not isinstance(state.params, tuple(api.PARAM_MODULES.values())):
        raise NotImplementedError(
            f"{type(state.params).__name__} training states are not "
            f"ported; only {', '.join(modules)}")
    return state.params


def _key_sets(model: torch.nn.Module) -> tuple[set, set]:
    """``model``'s parameter names and the optimizer's stack keys: the
    key sets of the optimizer-state dicts that follow the params."""
    names = [n for n, _ in model.named_parameters()]
    return set(names), set(adafactor_stacks(names))


def _opt_to_reference(node, model: torch.nn.Module, keys: tuple[set, set]):
    """An optimizer state with every dict keyed by parameter names or
    stack keys put in the reference's tree, bottom up."""
    if isinstance(node, dict):
        node = {k: _opt_to_reference(v, model, keys) for k, v in node.items()}
        return _to_reference(node, model) if set(node) in keys else node
    if isinstance(node, (tuple, list)):
        return type(node)(_opt_to_reference(v, model, keys) for v in node)
    return node


def _opt_from_reference(node, like, model: torch.nn.Module,
                        keys: tuple[set, set]):
    """The inverse of ``_opt_to_reference``, shaped by the port-form state
    ``like`` (``meta`` leaves are fine): the reference-form ``node``'s
    values at ``like``'s keys."""
    if isinstance(like, dict):
        if set(like) in keys:
            node = _from_reference(node, like, model)
        return {k: _opt_from_reference(node[k], v, model, keys)
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_opt_from_reference(n, v, model, keys)
                          for n, v in zip(node, like))
    return node


def reference_tree(state: TrainState) -> TrainState:
    """The port's ``TrainState`` in the reference's tree, leaves untouched
    (``meta`` tensors stay ``meta``): params nested by name (a
    ``StackedLM``'s layers as ``Stacked`` leaves), every dict of the
    optimizer state keyed by the parameter names or by stack keys nested
    the same way, the step a 0-d int32 tensor."""
    model = _module_of(state)
    return TrainState(
        params=_to_reference(dict(model.named_parameters()), model),
        opt_state=_opt_to_reference(state.opt_state, model,
                                    _key_sets(model)),
        sampler_state=SamplerState(stats=dict(state.sampler_state.stats),
                                   const=dict(state.sampler_state.const)),
        step=torch.tensor(state.step, dtype=torch.int32))


def from_reference_tree(tree: TrainState, like: TrainState) -> TrainState:
    """The inverse of ``reference_tree``: ``like`` gives the module (its
    class and configuration; ``meta`` is fine) and the optimizer state's
    form, the tree the tensors."""
    model = copy.deepcopy(_module_of(like))
    keys = _key_sets(model)
    model.load_state_dict(_from_reference(tree.params, keys[0], model),
                          assign=True)
    return TrainState(params=model,
                      opt_state=_opt_from_reference(tree.opt_state,
                                                    like.opt_state, model,
                                                    keys),
                      sampler_state=tree.sampler_state, step=int(tree.step))


def params_to_jax(model: torch.nn.Module | dict) -> dict:
    """A ``RecsysTower``, ``LSTMLM``, ``StackedLM`` or an LM's stacked tree
    -> the reference's param tree of numpy arrays (the inverse of
    ``params_from_jax``)."""
    if isinstance(model, dict):
        return _map_tree(host_copy, model)
    return named_to_jax(model, dict(model.named_parameters()))


def named_to_jax(model: torch.nn.Module, named: dict) -> dict:
    """Tensors keyed by ``model``'s parameter names (the parameters, their
    gradients, an optimizer moment) -> the reference's tree of that
    model's params, numpy leaves."""
    return _map_tree(host_copy, _to_reference(named, model))


def train_state_to_jax(state: TrainState, cfg: ArchConfig | None = None,
                       ctx=None) -> tuple[dict, tuple, dict, int]:
    """The port's ``TrainState`` -> ``(np_params, np_opt_state,
    np_sampler, step)``, numpy copies on the host: the arguments
    ``train_state_from_jax`` takes.  On a mesh (``cfg`` and ``ctx``) a
    rank's shards gathered whole first (the sampler's state stays the
    rank's)."""
    if rules.on_mesh(ctx):
        state = gather_train_state(state, cfg, ctx)
    tree = reference_tree(state)
    return (_map_tree(host_copy, tree.params),
            _map_tree(host_copy, tree.opt_state),
            {"stats": _map_tree(host_copy, tree.sampler_state.stats),
             "const": _map_tree(host_copy, tree.sampler_state.const)},
            state.step)


def _tensor(arr, dev: torch.device, dtype=None) -> torch.Tensor:
    return from_numpy(arr).to(device=dev, dtype=dtype)


def _leaf(arr, dev: torch.device) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype; bf16 (numpy has none:
    ``ml_dtypes``) crosses as fp32, exactly, and is cast back."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return _tensor(arr.astype(np.float32), dev, torch.bfloat16)
    return _tensor(arr, dev)


def _tensor_tree(tree, dev: torch.device):
    """A tree of numpy leaves in dicts, tuples and lists -> the same of
    tensors."""
    if isinstance(tree, dict):
        return {k: _tensor_tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensor_tree(v, dev) for v in tree)
    return _leaf(tree, dev)


def lm_params_from_jax(np_params: dict, cfg: ArchConfig,
                       device: str | torch.device | None = None) -> dict:
    """Reference LM params (``transformer.init_lm``'s tree, numpy leaves;
    or an encoder-decoder's ``init_encdec`` tree) -> the port's tree of
    tensors on ``device`` (the card unless ``device="cpu"``), leaf for
    leaf."""
    dev = resolve_device(device)
    if cfg.family == "encdec":
        counts = {"enc_blocks": cfg.n_enc_layers,
                  "dec_blocks": cfg.n_dec_layers}
        got = {k: _first_dim(np_params.get(k)) for k in counts}
        if got != counts:
            raise ValueError(f"{cfg.name} stacks {counts} layers, the "
                             f"params {got}")
        return _tensor_tree(np_params, dev)
    require_ported(cfg)
    n_segs = len(segments_of(cfg))
    if len(np_params.get("segments", ())) != n_segs:
        raise ValueError(f"{cfg.name} has {n_segs} segments, the params "
                         f"{len(np_params.get('segments', ()))}")
    return _tensor_tree(np_params, dev)


def _first_dim(tree) -> int | None:
    """The leading dim of a tree's first leaf (a stack's layer count)."""
    while isinstance(tree, dict) and tree:
        tree = next(iter(tree.values()))
    return None if tree is None or isinstance(tree, dict) \
        else np.shape(tree)[0]


def caches_from_jax(np_caches, cfg: ArchConfig,
                    device: str | torch.device | None = None, ctx=None):
    """Reference decode caches (``transformer.init_cache`` / ``prefill``'s
    list, one dict per segment or one latent array per MLA segment; an
    encoder-decoder's one dict of four (L, B, S, KV, hd) arrays; numpy
    leaves) -> the port's on ``device`` (the card unless
    ``device="cpu"``), leaf for leaf.  With a serving mesh ``ctx`` each
    leaf is cut to this rank's block by ``transformer.cache_specs`` (K/V
    and latent rows their data rows and sequence range, a mamba leaf its
    data rows and channels) or ``encdec.cache_specs`` (each of the four
    its data rows and sequence range)."""
    dev = resolve_device(device)
    if cfg.family == "encdec":
        want = {"self_k", "self_v", "cross_k", "cross_v"}
        if set(np_caches) != want:
            raise ValueError(f"an encoder-decoder's cache holds "
                             f"{sorted(want)}, not {sorted(np_caches)}")
        cache = _tensor_tree(dict(np_caches), dev)
        if not rules.on_mesh(ctx):
            return cache
        specs = encdec.cache_specs(cfg, *_dec_cache_dims(cache), ctx)
        return {k: rules.shard_by_spec(t, specs[k], ctx)
                for k, t in cache.items()}
    n_segs = len(segments_of(cfg))
    if len(np_caches) != n_segs:
        raise ValueError(f"{cfg.name} has {n_segs} segments, the caches "
                         f"{len(np_caches)}")
    caches = _tensor_tree(list(np_caches), dev)
    if not rules.on_mesh(ctx):
        return caches
    batch, max_len = _cache_dims(caches)
    specs = transformer.cache_specs(cfg, batch, max_len, ctx)
    out = []
    for c, spec in zip(caches, specs):
        if isinstance(c, dict):
            c = {k: rules.shard_by_spec(t, spec[k], ctx)
                 for k, t in c.items()}
        else:
            c = rules.shard_by_spec(c, spec, ctx)
        out.append(c)
    return out


def _cache_dims(caches) -> tuple[int, int | None]:
    """(batch, max_len) of a whole LM cache list (max_len None without an
    attention segment)."""
    batch, max_len = None, None
    for c in caches:
        t = c["k"] if isinstance(c, dict) and "k" in c else c
        if isinstance(t, dict):
            batch = t["conv"].shape[1]
        else:
            batch, max_len = t.shape[1], t.shape[2]
    return batch, max_len


def _dec_cache_dims(cache: dict) -> tuple[int, int, int]:
    """(batch, max_len, frames) of a whole encoder-decoder cache."""
    _, batch, max_len = cache["self_k"].shape[:3]
    return batch, max_len, cache["cross_k"].shape[2]


def caches_to_jax(caches, cfg: ArchConfig | None = None, ctx=None,
                  batch: int | None = None, max_len: int | None = None,
                  frames: int | None = None):
    """The port's decode caches -> numpy copies, the reference's layout
    (a list per segment, or an encoder-decoder's dict).  A serving mesh
    rank's blocks (``cfg`` and ``ctx``) are gathered whole, every rank of
    the mesh calling this: ``batch`` is the whole batch (a rank's rows
    alone do not tell a block of dp from a whole batch that dp does not
    divide), ``max_len`` the whole sequence where the caches hold
    attention (neither does a rank's range: ``rules.seq_shards``), and
    ``frames`` an encoder-decoder's cross caches' whole length."""
    if not rules.on_mesh(ctx):
        if isinstance(caches, dict):
            return _map_tree(host_copy, caches)
        return _map_tree(host_copy, list(caches))
    if batch is None:
        raise ValueError("caches on a mesh gather with their whole batch "
                         "(batch=)")
    if isinstance(caches, dict):
        if max_len is None or frames is None:
            raise ValueError("an encoder-decoder's caches on a mesh gather "
                             "with their whole lengths (max_len=, frames=)")
        specs = encdec.cache_specs(cfg, batch, max_len, frames, ctx)
        return {k: host_copy(rules.gather_by_spec(t, specs[k], ctx))
                for k, t in caches.items()}
    if max_len is None and _cache_dims(caches)[1] is not None:
        raise ValueError("attention caches on a mesh gather with their "
                         "whole length (max_len=)")
    specs = transformer.cache_specs(cfg, batch, max_len or 1, ctx)
    out = []
    for c, spec in zip(caches, specs):
        if isinstance(c, dict):
            out.append({k: host_copy(rules.gather_by_spec(t, spec[k], ctx))
                        for k, t in c.items()})
        else:
            out.append(host_copy(rules.gather_by_spec(c, spec, ctx)))
    return out


def lm_shards_from_jax(np_params: dict, cfg: ArchConfig, ctx,
                       device: str | torch.device | None = None
                       ) -> StackedLM | EncDec:
    """Reference LM params (the whole tree, padded for the mesh as the
    reference's ``init_lm`` pads it for ``ctx``; or an encoder-decoder's,
    as ``init_encdec`` pads it) -> a ``StackedLM`` (an ``EncDec``) of this
    rank's shards by ``rules.param_specs_for`` in ``ctx``'s mode
    (``train.step.shard_params``: ``shard_by_spec`` of each leaf), with
    its ``param_specs`` set: what the serving engine takes on a mesh
    (``rules.ctx_for_serve``: tp, or tp_fsdp where ``serve_fsdp``) and the
    train step in the training modes."""
    from repro_torch.train.step import shard_params

    dev = resolve_device(device)
    module = EncDec if cfg.family == "encdec" else StackedLM
    model = module(cfg, dev, tree=lm_params_from_jax(np_params, cfg, dev))
    return shard_params(model, cfg, ctx)


def params_from_jax(np_params: dict, cfg: ArchConfig,
                    device: str | torch.device | None = None):
    """Reference params (numpy leaves) -> the port's on ``device`` (the
    card unless ``device="cpu"``): a ``RecsysTower`` for recsys, an
    ``LSTMLM`` for lstm, the stacked tensor tree for the decoder LMs and
    the encoder-decoder."""
    dev = resolve_device(device)
    if cfg.family in LM_FAMILIES + ("encdec",):
        return lm_params_from_jax(np_params, cfg, dev)
    if cfg.family not in api.PARAM_MODULES:
        raise NotImplementedError(
            f"family '{cfg.family}' is not ported (only 'recsys', 'lstm', "
            f"{', '.join(repr(f) for f in LM_FAMILIES)}, 'encdec')")
    # Built on the meta device, so nothing is allocated or drawn before
    # the copies are assigned.
    model = api.abstract_params(cfg)
    state = _flat_params(np_params)
    own = model.state_dict()
    if set(state) != set(own):
        raise ValueError(f"param names differ: {sorted(state)} vs "
                         f"{sorted(own)}")
    model.load_state_dict({k: _tensor(v, dev, own[k].dtype)
                           for k, v in state.items()}, assign=True)
    return model


#: the reference optimizer's state keys -> the port's transform, for the
#: template of a carried state
_OPTIMIZERS = {frozenset({"m", "v", "step"}): adamw,
               frozenset({"v", "step"}): adafactor}


def _stat_spec(spec: tuple, which: str) -> tuple:
    """The spec of an optimizer leaf of a leaf of spec ``spec``: Adafactor's
    ``vr`` keeps all dims but the last, ``vc`` all but the second to last;
    a moment (or the unfactored ``v``) is the leaf's shape."""
    if which == "vr":
        return spec[:-1]
    if which == "vc":
        return spec[:-2] + spec[-1:]
    return spec


def _opt_specs(node, specs: dict, stack_of: dict):
    """The spec of each tensor of a port-form optimizer state (None for
    the step counts): a dict keyed by parameter names by their specs, one
    keyed by Adafactor's stack keys by ``_stat_spec`` of the stack's (its
    layer dim unsharded)."""
    if isinstance(node, dict):
        stats = all(isinstance(v, dict) and v and set(v) <= {"vr", "vc", "v"}
                    for v in node.values())
        if node and not stats and set(node) <= set(specs):
            return {k: specs[k] for k in node}
        if node and stats and set(node) <= set(stack_of):
            out = {}
            for key, stats in node.items():
                members = stack_of[key]
                spec = specs[members[0]]
                if key != members[0]:
                    spec = (None,) + spec
                out[key] = {w: _stat_spec(spec, w) for w in stats}
            return out
        return {k: _opt_specs(v, specs, stack_of) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_opt_specs(v, specs, stack_of) for v in node)
    return None


def _vocab_padded(cfg: ArchConfig, spec, ctx) -> bool:
    """True for a leaf whose rows are the vocab of a recsys or lstm table
    that the mesh pads to a multiple of tp (``train.step.shard_params``)."""
    from repro_torch.train.step import PADDED_TABLES

    return (cfg.family in PADDED_TABLES and bool(spec)
            and spec[0] == ctx.model_axis)


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return tree if specs is None else fn(tree, specs)


def shard_train_state(state: TrainState, cfg: ArchConfig, ctx
                      ) -> TrainState:
    """A whole ``TrainState`` -> this rank's: its parameters sharded by
    ``train.step.shard_params`` (in place), every optimizer tensor by the
    spec of the parameter it follows (``_opt_specs``), a recsys or lstm
    table's moments padded as its rows are.  Bitwise: each shard is a
    slice."""
    from repro_torch.train.step import shard_params

    model = shard_params(state.params, cfg, ctx)
    stack_of = adafactor_stacks(model.param_specs)

    def shard(t, spec):
        if _vocab_padded(cfg, spec, ctx):
            t = rules.pad_rows(t, ctx.tp)
        return rules.shard_by_spec(t, spec, ctx)

    opt_state = _zip_map(shard, state.opt_state,
                         _opt_specs(state.opt_state, model.param_specs,
                                    stack_of))
    return TrainState(params=model, opt_state=opt_state,
                      sampler_state=state.sampler_state, step=state.step)


def gather_train_state(state: TrainState, cfg: ArchConfig, ctx
                       ) -> TrainState:
    """The inverse of ``shard_train_state``: a rank's ``TrainState`` with
    every parameter and optimizer tensor gathered whole over the mesh (a
    recsys or lstm table's padded rows dropped), a new module without
    specs; the sampler's state is the rank's."""
    from repro_torch.train.step import gather_params, set_params

    model = state.params
    specs = model.param_specs
    stack_of = adafactor_stacks(specs)

    def gather(t, spec):
        with torch.no_grad():
            t = rules.gather_by_spec(t.detach(), spec, ctx)
        return t[:cfg.vocab_size] if _vocab_padded(cfg, spec, ctx) else t

    whole = copy.deepcopy(model)
    whole.param_specs = None
    set_params(whole, {k: t[:cfg.vocab_size] if _vocab_padded(
        cfg, specs[k], ctx) else t for k, t in gather_params(
            model, ctx).items()})
    opt_state = _zip_map(gather, state.opt_state,
                         _opt_specs(state.opt_state, specs, stack_of))
    return TrainState(params=whole, opt_state=opt_state,
                      sampler_state=state.sampler_state, step=state.step)


def train_state_from_jax(np_params: dict, np_opt_state, np_sampler: dict,
                         step: int, cfg: ArchConfig,
                         device: str | torch.device | None = None,
                         ctx=None) -> TrainState:
    """A reference ``TrainState`` as numpy -> the port's, on ``device``.

    np_params: the recsys, lstm or LM param tree; np_opt_state: the state
    of ``make_optimizer("adamw", ...)``, i.e. ``((), {"m": tree, "v":
    tree, "step": int32})``, or of ``make_optimizer("adafactor", ...)``,
    ``((), {"v": tree of {"vr", "vc"} or {"v"}, "step": int32})``;
    np_sampler: ``{"stats": {...}, "const": {...}}`` of the sampler's
    carried state (``{}`` dicts for none; on a mesh the rank's own); step:
    the train step count.  On a mesh (``ctx``) the params and the
    optimizer's state go onto this rank's shards (``shard_train_state``;
    an LM's tree padded for the mesh as ``init_lm`` pads it)."""
    if rules.on_mesh(ctx):
        return shard_train_state(train_state_from_jax(
            np_params, np_opt_state, np_sampler, step, cfg, device), cfg,
            ctx)
    dev = resolve_device(device)
    model = params_from_jax(np_params, cfg, device=dev)
    if cfg.family in LM_FAMILIES:
        model = StackedLM(cfg, dev, tree=model)
    elif cfg.family == "encdec":
        model = EncDec(cfg, dev, tree=model)
    clip_state, core = np_opt_state
    opt = _OPTIMIZERS.get(frozenset(core)) \
        if isinstance(core, dict) else None
    if clip_state != () or opt is None:
        raise NotImplementedError(
            "only the chain(clip_by_global_norm, adamw) and chain("
            "clip_by_global_norm, adafactor) states are carried")
    meta = api.abstract_params(cfg, **(
        {"max_len": np.shape(np_params["enc_pos"]["table"])[0]}
        if cfg.family == "encdec" else {}))
    like = chain(clip_by_global_norm(1.0), opt(0.0)).init(
        dict(meta.named_parameters()))
    opt_state = _opt_from_reference(_tensor_tree(np_opt_state, dev), like,
                                    model, _key_sets(model))
    sampler_state = SamplerState(
        stats={k: _tensor(v, dev) for k, v in np_sampler["stats"].items()},
        const={k: _tensor(v, dev) for k, v in np_sampler["const"].items()})
    return TrainState(params=model, opt_state=opt_state,
                      sampler_state=sampler_state, step=int(step))


def index_from_jax(np_fields: dict,
                   device: str | torch.device | None = None, ctx=None
                   ) -> RetrievalIndex | QuantizedRetrievalIndex:
    """Reference ``RetrievalIndex`` or ``QuantizedRetrievalIndex`` fields
    (numpy tensors plus the ints ``n``, ``tp``, ``v_shard`` and, for the
    quantized one, ``bits``) -> the port's index on ``device``.  Of a
    sharded (tp > 1) ``RetrievalIndex``, whose tensors hold the shards'
    heaps one after another, a rank of a mesh ``ctx`` of that tp keeps its
    own shard; without one it raises.  So does a sharded
    ``QuantizedRetrievalIndex``, whose tensors hold the shards' lists one
    after another."""
    dev = resolve_device(device)
    cls = QuantizedRetrievalIndex if "bits" in np_fields else RetrievalIndex
    tp = int(np_fields["tp"])
    statics = {f: int(np_fields[f]) for f in ("n", "tp", "v_shard", "bits")
               if f in np_fields}
    if tp == 1:
        return cls(**{f: _tensor(np_fields[f], dev) for f in cls.TENSORS},
                   **statics)
    if not rules.on_mesh(ctx) or ctx.tp != tp:
        raise ValueError(f"an index sharded over tp={tp} crosses onto a "
                         f"rank of a mesh of that tp (ctx)")
    j = ctx.model_index
    return cls(**{f: _tensor(np.split(np.asarray(np_fields[f]), tp)[j], dev)
                  for f in cls.TENSORS}, **statics, shard_index=j)


def index_to_jax(index: RetrievalIndex | QuantizedRetrievalIndex,
                 ctx=None) -> dict:
    """A port index's fields as host copies (numpy tensors, ints): the
    keyword arguments of the reference's index class.  A sharded index's
    tensors are gathered over the model group of its mesh ``ctx``, every
    rank of which calls this, shard after shard as the reference packs
    them."""
    host = host_copy
    if index.tp != 1:
        if not rules.on_mesh(ctx) or (ctx.tp, ctx.model_index) != (
                index.tp, index.shard_index):
            raise ValueError(f"shard {index.shard_index} of an index "
                             f"sharded over tp={index.tp} gathers over its "
                             f"mesh (ctx)")

        def host(x):
            return host_copy(distributed.all_gather_tiled(
                x, ctx.model_group))
    return {f.name: host(getattr(index, f.name))
            if f.name in index.TENSORS else getattr(index, f.name)
            for f in dataclasses.fields(index) if f.name != "shard_index"}

