"""The train step, unsharded (``repro.train.step`` with ``mesh=None``).

Data flow per step (youtube-dnn; the LMs' backbones give h (B*S, d) the
same way, the dense family's attention through the flash kernels):

  batch --> tower --> h (B, d)
  sampler-stat refresh from the head on the cadence
      (``cfg.sampler_refresh_every``; ``zstats`` on the card)
  per-example kernel sampling of m negatives   [``block_scores`` root step,
      ``leaf_scores`` within-block step], under ``torch.no_grad()``
  estimator-routed corrected loss               [eq. 2-3 through the fused
      head: ``fused_lse`` forward, ``fused_lse_bwd`` backward]
  loss --> autograd (summed into each parameter's ``.grad`` over the
      microbatches, then taken off it) --> clip + AdamW or Adafactor,
      applied to the parameters in place

Sampler statistics are carried in ``TrainState.sampler_state``, a
``SamplerState`` owned by the sampler.  The correction always uses the
statistics actually sampled from, so staleness costs bias-of-q only.

The refresh branches on the host (the reference computes both sides and
selects with ``jnp.where``; the result is the same).  Under
``refresh_mode="overlap"`` the step never rebuilds: the loop's
``RefreshIsland`` rebuilds from a snapshot of the head on a side stream
and swaps the result in.

On a ``(data, model)`` mesh (``sharding/rules.py::mesh_ctx``) each rank
holds its shard of every parameter by the reference's rules
(``shard_params``: the head's vocab rows over ``model``, ZeRO-3 over
``data``, Megatron's slices over ``model``) and its shard of the
sampler's statistics, and trains on its block of the batch (over data,
or data x model in ``pure_fsdp``).  The backbone gathers each shard
before use (``api.backbone_hidden(..., ctx)``); the head island gathers
the head's feature dim over data, rebuilds the shard's statistics from
its rows with its ``n_valid``, and takes the loss through
``core/distributed.py::sharded_estimator_loss`` over the model group
with the step's generator folded by the data position only (the shard
index is folded in below it).  In ``pure_fsdp`` the island first
all-gathers h and the labels over ``model``, so each model column holds
its data row's tokens; the loss sum is a psum over the data group.  A
sharded parameter's gradient arrives summed and sharded through its
gather's backward (a reduce-scatter); the gradient of one replicated
over a batch axis is all-reduced over it (``rules.grad_reduce_axes``),
and over ``model`` too where each model rank holds a part of it
(``rules.model_partial``: the router, MLA's latent leaves, the per-head
q/k norms, and under sequence parallelism the replicated leaves that act
on S-shards: norms, ``bo``, ``b_down``); clipping's global norm and
Adafactor's statistics sum each leaf over the axes that shard it
(``ShardedGrads``).  Every family trains there with every carrying
sampler (each shard's block, tree, rff or midx statistics built from its
own rows, padding rows at zero mass) and either refresh mode: the moe and
hybrid families with their experts over ``model`` (each microbatch's
capacity from its own rows), MLA over heads, the mtp rows, and the expert
configs' residual stream S-sharded (``cfg.seq_sharded_residuals``).
Experts in ``pure_fsdp`` raise, as the reference asserts.

``serving_index_source`` is the seam between training and serving: it
restores the newest complete checkpoint and exports a fresh serving index
from its head, the hierarchy's ``RetrievalIndex`` or (``quantized=True``)
the midx ``QuantizedRetrievalIndex``.
"""
from __future__ import annotations

import dataclasses
import zipfile
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import distributed, estimators
from repro_torch.core.samplers import (
    SamplerState,
    empty_state,
    sampler_from_config,
)
from repro_torch.models import api, transformer
from repro_torch.models.layers import padded_heads
from repro_torch.models.transformer import LM_FAMILIES
from repro_torch.optim.clip import ShardedGrads
from repro_torch.optim.transform import GradientTransform, apply_updates
from repro_torch.serve import quantized_index, retrieval
from repro_torch.sharding import rules
from repro_torch.utils.misc import fold_generator, fold_in, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    """Carried training state.

    ``params`` is the model (an ``nn.Module``: ``RecsysTower``,
    ``LSTMLM``, ``StackedLM`` or ``EncDec``, updated in place by each
    step);
    ``opt_state`` the optimizer's state; ``sampler_state`` the
    sampler-owned ``SamplerState``; ``step`` the host step count."""

    params: torch.nn.Module
    opt_state: Any
    sampler_state: SamplerState
    step: int


def param_dict(model: torch.nn.Module) -> dict[str, Tensor]:
    """The model's parameters by name: what the optimizers update."""
    return dict(model.named_parameters())


_A17 = "(ROADMAP.md A17)"


def _on_mesh(cfg: ArchConfig, ctx) -> bool:
    """True on a mesh, after refusing a family with no mesh layouts and
    experts outside tp_fsdp (the reference's assertion: the experts live
    on ``model``)."""
    if not rules.on_mesh(ctx):
        return False
    api.require_mesh_layout(cfg)
    if cfg.n_experts and ctx.mode == "pure_fsdp":
        raise ValueError(f"'{cfg.name}': MoE archs must use tp_fsdp "
                         "sharding (experts live on `model`)")
    return True


def _partial_leaves(model, cfg: ArchConfig, ctx, s: int | None) -> set:
    """The parameters whose gradient each model rank holds a part of
    (``rules.model_partial``), for an LM at sequence length ``s``."""
    lm = cfg.family in LM_FAMILIES and s is not None
    return {k for k, spec in model.param_specs.items()
            if rules.model_partial(k, spec, ctx, lm and rules.seq_sharded(
                ctx, transformer.residual_rows(k, s)))}


def shard_n_valid(cfg: ArchConfig, ctx) -> int:
    """True classes among this rank's head rows (all of them unsharded)."""
    if not rules.on_mesh(ctx):
        return cfg.vocab_size
    v_l = rules.vocab_shard(cfg.vocab_size, ctx.tp)
    return rules.local_n_valid(cfg.vocab_size, v_l, ctx.model_index)


def shard_params(model: torch.nn.Module, cfg: ArchConfig, ctx
                 ) -> torch.nn.Module:
    """Keep this rank's shard of every parameter of a whole model (in
    place), by ``rules.param_specs_for``, and set ``model.param_specs``.
    A recsys or lstm model's tables are padded with zero rows to a
    multiple of tp first (the V rule; an LM's or an encoder-decoder's
    vocab is padded by its init).  Returns the model."""
    if cfg.family in LM_FAMILIES + ("encdec",):
        _require_heads_padded(model, cfg, ctx)
    whole = {}
    for name, p in model.named_parameters():
        t = p.detach()
        if name in PADDED_TABLES.get(cfg.family, ()):
            t = rules.pad_rows(t, ctx.tp)
        whole[name] = t
    specs = rules.param_specs_for(whole, ctx)
    set_params(model, {name: rules.shard_by_spec(t, specs[name], ctx)
                       for name, t in whole.items()})
    model.param_specs = specs
    return model


def set_params(model: torch.nn.Module, named: dict[str, Tensor]) -> None:
    """Put each tensor of ``named`` in the module as the parameter of its
    name (a new ``Parameter``, whatever its shape)."""
    for name, t in named.items():
        mod_name, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(mod_name), leaf, torch.nn.Parameter(t))


#: family -> its tables whose rows ``shard_params`` pads to a multiple of
#: tp (the others' inits pad them)
PADDED_TABLES = {"recsys": ("embed_table", "head_w"),
                 "lstm": ("embed_table", "head_w")}


def _require_heads_padded(model: torch.nn.Module, cfg: ArchConfig, ctx
                          ) -> None:
    """Raise unless the LM's or encoder-decoder's head counts are the ones
    its init pads to for the mesh (``padded_heads`` at
    ``ctx.tp_backbone``; every self and cross attention), and its vocab
    the rows it pads to (a multiple of ``ctx.tp``): the M rule would
    otherwise split a head across ranks, the V rule leave the vocab
    whole."""
    hd = cfg.resolved_head_dim
    want = padded_heads(cfg, ctx.tp_backbone)
    for name, p in model.named_parameters():
        if name.endswith("attn.wk"):
            wq = model.get_parameter(name[:-2] + "wq")
            got = (wq.shape[1] // hd, p.shape[1] // hd)
            if got != want:
                raise ValueError(
                    f"{name}: {got} q / kv heads, the mesh's backbone "
                    f"(tp {ctx.tp_backbone}) needs {want}: init the model "
                    "for the mesh (init_lm(..., ctx=ctx))")
    rows = model.get_parameter("embed.table").shape[0]
    if rows % ctx.tp or rows - cfg.vocab_size >= ctx.tp:
        raise ValueError(f"embed.table: {rows} rows, the mesh's head (tp "
                         f"{ctx.tp}) needs {cfg.vocab_size} padded to a "
                         "multiple of it: init the model for the mesh")


def gather_params(model: torch.nn.Module, ctx) -> dict[str, Tensor]:
    """Every parameter of a rank's sharded model gathered whole (the
    inverse of ``shard_params``; the padded rows kept), no gradient."""
    specs = model.param_specs
    with torch.no_grad():
        return {k: rules.gather_by_spec(p.detach(), specs[k], ctx)
                for k, p in model.named_parameters()}


def make_refresh_fn(cfg: ArchConfig, ctx=None
                    ) -> Callable[[Tensor, SamplerState], SamplerState]:
    """Unconditional sampler-stat rebuild from the head table (on a mesh,
    this rank's shard from its rows and ``n_valid``).  A no-op (state
    passes through) for stateless samplers or dense estimators."""
    mesh = _on_mesh(cfg, ctx)
    cfg.validate(tp=ctx.tp if mesh else 1)
    sampler = sampler_from_config(cfg)
    estimator = estimators.make_estimator(cfg.estimator)
    carries_stats = sampler.carries_state and estimator.needs_sampling
    n_valid = shard_n_valid(cfg, ctx)

    @torch.no_grad()
    def refresh_fn(head: Tensor, sampler_state: SamplerState
                   ) -> SamplerState:
        if not carries_stats:
            return sampler_state
        stats = sampler.build_stats(head.detach(), n_valid,
                                    sampler_state.const)
        return SamplerState(stats=stats, const=dict(sampler_state.const))

    refresh_fn.carries_stats = carries_stats
    return refresh_fn


def _split_microbatches(batch: dict, mu: int) -> list[dict]:
    """(B, ...) -> mu microbatches of B/mu rows, row j of microbatch i being
    row j*mu + i, as the reference interleaves them; every key alike (an
    encoder-decoder's frames with its tokens and labels)."""
    b = next(iter(batch.values())).shape[0]
    assert b % mu == 0, f"batch {b} % microbatches {mu} != 0"
    return [{k: x[i::mu] for k, x in batch.items()} for i in range(mu)]


def _take_grad(p: torch.nn.Parameter, mu: int) -> Tensor:
    """``p``'s summed gradient over ``mu`` microbatches as their mean
    (zeros where ``p`` was unused), taken off ``p`` so the optimizer
    holds the only reference."""
    g = p.grad if p.grad is not None else torch.zeros_like(p)
    p.grad = None
    return g.div_(mu) if mu > 1 else g


def make_train_step(cfg: ArchConfig, ctx, opt: GradientTransform,
                    aux_coef: float = 0.01
                    ) -> Callable[[TrainState, dict, torch.Generator],
                                  tuple[TrainState, dict]]:
    """``train_step(state, batch, gen) -> (state, metrics)``; ``gen``
    draws the step's negatives.  On a mesh ``batch`` is this rank's data
    block and ``gen`` the step's generator, alike on every rank."""
    mesh = _on_mesh(cfg, ctx)
    cfg.validate(tp=ctx.tp if mesh else 1)
    sampler = sampler_from_config(cfg)
    estimator = estimators.make_estimator(cfg.estimator)
    m = cfg.m_negatives
    refresh_fn = make_refresh_fn(cfg, ctx)
    every = max(cfg.sampler_refresh_every, 1)
    # overlap: the loop's RefreshIsland rebuilds and swaps the statistics in
    in_step_refresh = cfg.refresh_mode != "overlap"
    n_valid = shard_n_valid(cfg, ctx)
    mg = ctx.model_group if mesh else None
    dg = ctx.data_group if mesh else None
    n_data = ctx.axis_size(ctx.data_axes) if mesh else 1
    pure_fsdp = mesh and ctx.mode == "pure_fsdp"

    def local_loss(model, mb, sstate, gen):
        h2d, labels, aux = api.backbone_hidden(model, mb, cfg)
        head = api.head_table(model, cfg)
        lsum = torch.sum(estimators.local_sampled_loss(
            estimator, sampler, head, h2d, labels, sstate, m, gen,
            n_valid=cfg.vocab_size, abs_mode=cfg.abs_softmax,
            impl=cfg.head_impl))
        loss = lsum / h2d.shape[0]
        return loss + aux_coef * aux, loss, aux

    def mesh_loss(model, mb, sstate, gen):
        """The head island of the reference's shard_map: this rank's head
        shard (its feature dim gathered) over its data row's tokens; the
        returned loss is the GLOBAL mean, alike on every rank."""
        h2d, labels, aux = api.backbone_hidden(model, mb, cfg, ctx)
        head = api.head_table(model, cfg, ctx)
        state_local = None
        if estimator.needs_sampling:
            with torch.no_grad():
                state_local = sampler.island_runtime(sstate, head.detach(),
                                                     n_valid)
        if pure_fsdp:
            # the model column's tokens, every one on each of its ranks:
            # the gather's backward sums each rank's shard terms of dL/dh
            h_in = distributed.all_gather_tiled(h2d, mg)
            labels = distributed.all_gather_tiled(labels, mg)
        else:
            h_in = distributed.replicated(h2d, mg)
        losses = distributed.sharded_estimator_loss(
            estimator, head, h_in, labels, sampler, state_local, m,
            fold_generator(gen, ctx.data_index), group=mg,
            abs_mode=cfg.abs_softmax, impl=cfg.head_impl)
        lsum = distributed.psum(torch.sum(losses), dg)
        loss = lsum / (h_in.shape[0] * n_data)
        return loss + aux_coef * aux, loss, aux

    loss_fn = mesh_loss if mesh else local_loss

    def accumulate(model, params, mb, sstate, gen):
        """One (micro)batch's loss, its gradients ADDED into each
        parameter's ``.grad`` (autograd frees each incoming gradient as
        it lands, so one set of gradients is held, not two)."""
        total, loss, aux = loss_fn(model, mb, sstate, gen)
        torch.autograd.backward(total, inputs=list(params.values()))
        return total.detach(), loss.detach(), aux.detach()

    def train_step(state: TrainState, batch: dict, gen: torch.Generator
                   ) -> tuple[TrainState, dict]:
        sstate = state.sampler_state
        if in_step_refresh and state.step % every == 0:
            with torch.no_grad():
                head = api.head_table(state.params, cfg,
                                      ctx if mesh else None)
            sstate = refresh_fn(head, sstate)
        params = param_dict(state.params)
        for p in params.values():
            p.grad = None
        mu = max(cfg.microbatches, 1)
        if mu == 1:
            total, loss, aux = accumulate(state.params, params, batch,
                                          sstate, gen)
        else:
            # The reference sums the microbatches' gradients in fp32; the
            # port sums them in the parameters' dtype (the same sums for
            # fp32 parameters; for bf16 ones an fp32 sum would be twice
            # the parameters' bytes).
            total = loss = aux = 0.0
            for i, mb in enumerate(_split_microbatches(batch, mu)):
                # on a mesh each microbatch's negatives from its own key,
                # as the reference splits it
                t_i, l_i, a_i = accumulate(
                    state.params, params, mb, sstate,
                    fold_generator(gen, i) if mesh else gen)
                total, loss, aux = total + t_i, loss + l_i, aux + a_i
            total, loss, aux = total / mu, loss / mu, aux / mu
        grads = {k: _take_grad(p, mu) for k, p in params.items()}
        if mesh:
            specs = state.params.param_specs
            partial = _partial_leaves(state.params, cfg, ctx,
                                      batch["tokens"].shape[1]
                                      if "tokens" in batch else None)
            for k, g in grads.items():
                axes = rules.grad_reduce_axes(specs[k], ctx, k in partial)
                if axes:
                    distributed.all_reduce_(g, "sum", ctx.group(axes))
            grads = ShardedGrads(grads, specs, ctx)
        updates, opt_state = opt.update(grads, state.opt_state, params)
        del grads
        apply_updates(params, updates)
        new_state = TrainState(
            params=state.params, opt_state=opt_state,
            sampler_state=sstate if refresh_fn.carries_stats
            else state.sampler_state,
            step=state.step + 1)
        metrics = {"loss": loss.detach(), "aux_loss": aux.detach(),
                   "total_loss": total.detach()}
        return new_state, metrics

    return train_step


def export_retrieval_index(state: TrainState, cfg: ArchConfig, ctx,
                           leaf_size: int | None = None
                           ) -> retrieval.RetrievalIndex:
    """Packed serving index from a trained state: UNPROJECTED statistics
    of the current head table (``serve/retrieval.py::build_index``), never
    the carried sampler state, which may be projected and is one update
    stale.  On a mesh the rank's vocab shard, its features gathered."""
    with torch.no_grad():
        head = api.head_table(state.params, cfg, ctx).detach()
    return retrieval.build_index(head, ctx, leaf_size=leaf_size,
                                 vocab_size=cfg.vocab_size)


def export_quantized_index(state: TrainState, cfg: ArchConfig, ctx,
                           bits: int | None = None
                           ) -> quantized_index.QuantizedRetrievalIndex:
    """Quantized serving index from a trained state: the midx codebook
    structure over the current head table (never the carried sampler
    state), with ``cfg.midx_bits``-wide member rows unless ``bits`` says
    otherwise.  The knobs ride the config (``midx_codewords``,
    ``midx_codebooks``, ``sampler_block``), so the serving index mirrors the
    training-time midx sampler's structure.  On a mesh the rank's vocab
    shard, its features gathered, builds the rank's shard of the index."""
    with torch.no_grad():
        head = api.head_table(state.params, cfg, ctx).detach()
    return quantized_index.build_quantized_index(
        head, ctx, codewords=cfg.midx_codewords,
        codebooks=cfg.midx_codebooks, list_size=cfg.sampler_block,
        bits=bits if bits is not None else cfg.midx_bits,
        vocab_size=cfg.vocab_size)


def init_train_state(key: torch.Generator, cfg: ArchConfig, ctx,
                     opt: GradientTransform, max_len: int = 4096, *,
                     device: str | torch.device | None = None) -> TrainState:
    """Concrete init on ``device`` (the card unless ``device="cpu"``):
    weights drawn from the generator ``key``, the optimizer's zero state,
    and the sampler's statistics built from the initial head.  The
    sampler's constants come from a generator seeded off ``key``'s seed, as
    the reference folds 7 into its key.  ``max_len`` sizes an
    encoder-decoder's learned position tables, as in the reference (the
    other families have none).

    On a mesh every rank draws the same whole model from ``key``, padded
    as the reference pads it for the mesh (so the weights are those of
    the reference's init at that padding), and keeps its shards
    (``shard_params``); the optimizer's state takes the shards' shapes;
    its statistics are built from the head shard's rows (the reference
    allocates zeros, which the first step's refresh overwrites)."""
    mesh = _on_mesh(cfg, ctx)
    cfg.validate(tp=ctx.tp if mesh else 1)
    dev = resolve_device(device)
    sampler = sampler_from_config(cfg)
    estimator = estimators.make_estimator(cfg.estimator)
    model = api.init_module(cfg, key, device=dev, max_len=max_len,
                            ctx=ctx if mesh else None)
    if mesh and model.param_specs is None:
        shard_params(model, cfg, ctx)
    opt_state = opt.init(param_dict(model))
    sstate = empty_state()
    if sampler.carries_state and estimator.needs_sampling:
        const_gen = torch.Generator(dev).manual_seed(
            fold_in(key.initial_seed(), 7))
        with torch.no_grad():
            head = api.head_table(model, cfg, ctx if mesh else None)
            sstate = sampler.init_state(const_gen, head.detach(),
                                        n_valid=shard_n_valid(cfg, ctx))
    return TrainState(params=model, opt_state=opt_state,
                      sampler_state=sstate, step=0)


def abstract_train_state(cfg: ArchConfig, ctx, opt: GradientTransform,
                         max_len: int = 4096) -> TrainState:
    """The train state's structure on the ``meta`` device, nothing
    allocated: the restore template of ``CheckpointManager.restore``.
    Shapes and dtypes are those ``init_train_state`` gives at the same
    ``max_len``: on a mesh this rank's shards and statistics shard."""
    mesh = _on_mesh(cfg, ctx)
    cfg.validate(tp=ctx.tp if mesh else 1)
    sampler = sampler_from_config(cfg)
    estimator = estimators.make_estimator(cfg.estimator)
    model = api.abstract_params(cfg, max_len, ctx=ctx if mesh else None)
    if mesh:
        shard_params(model, cfg, ctx)
    sstate = empty_state()
    if sampler.carries_state and estimator.needs_sampling:
        sstate = (sampler.shard_state_shapes(cfg, ctx.tp) if mesh
                  else sampler.state_shapes(cfg))
    return TrainState(params=model, opt_state=opt.init(param_dict(model)),
                      sampler_state=sstate, step=0)


def serving_index_source(checkpoint_dir: str, cfg: ArchConfig, ctx,
                         opt: GradientTransform, *, max_len: int = 4096,
                         leaf_size: int | None = None,
                         quantized: bool = False,
                         device: str | torch.device | None = None
                         ) -> Callable[[], tuple | None]:
    """The serving half of the train -> serve refresh seam.

    Returns ``poll() -> (index, step) | None``: when a step newer than the
    last one served has landed COMPLETE in ``checkpoint_dir`` (the manager
    lists only renamed, manifest-bearing steps), restore it on ``device``
    (the card unless ``device="cpu"``) from an ``abstract_train_state``
    template and export a fresh index from its head: a ``RetrievalIndex``,
    or with ``quantized=True`` a ``QuantizedRetrievalIndex`` (knobs from
    ``cfg``; int8 rows at ``midx_bits=8``, about a quarter of the fp32
    payload); None when training has not advanced.  Built for
    ``serve.server.IndexRefresher``: the restore and the build run
    wherever ``poll`` is called, never on the decode path.

    A poll can still catch a directory mid-write (manifest landed, arrays
    not yet): a failed restore reports "nothing new" and leaves the last
    step served untouched, so the next poll retries it."""
    from repro_torch.checkpoint.manager import CheckpointManager

    if rules.on_mesh(ctx):
        raise NotImplementedError(
            f"per-process shard checkpoints are not ported {_A17}")
    dev = resolve_device(device)
    mgr = CheckpointManager(checkpoint_dir)
    like = abstract_train_state(cfg, ctx, opt, max_len=max_len)
    last: dict[str, int | None] = {"step": None}

    def poll():
        step = mgr.latest_step()
        if step is None or step == last["step"]:
            return None
        try:
            state, _ = mgr.restore(like=like, step=step, device=dev)
        except (OSError, KeyError, ValueError, EOFError,
                zipfile.BadZipFile):
            return None  # torn read: retry this step on the next poll
        last["step"] = step
        if quantized:
            return export_quantized_index(state, cfg, ctx), step
        return export_retrieval_index(state, cfg, ctx,
                                      leaf_size=leaf_size), step

    return poll
