"""Family dispatch: one API over the ported backbones (``repro.models.api``).

    init_params(cfg, gen, device, max_len) -> params (with head table)
    init_module(cfg, gen, device, max_len) -> the same as an ``nn.Module``
    backbone_hidden(params, batch, cfg) -> (h (T, d_h), labels (T,), aux)
    head_table(params, cfg)             -> (n, d_h) class-embedding table

Ported families: ``recsys`` (youtube-dnn; params are a ``RecsysTower``
module), ``lstm`` (ptb-lstm; an ``LSTMLM`` module, ``models/lstm_lm.py``)
and the decoder LMs, ``dense`` (llama3-8b, starcoder2-3b, ...), ``moe``
(dbrx-132b; deepseek-v3-671b with MLA and multi-token prediction), ``ssm``
(falcon-mamba-7b) and ``hybrid`` (jamba-v0.1-52b): params are the
reference's nested dict of stacked tensors (``models/transformer.py``),
and for training a ``StackedLM`` module over the same tensors; and the
encoder-decoder, ``encdec`` (whisper-large-v3, ``models/encdec.py``):
the reference's tree with its two block stacks and two learned position
tables of ``max_len`` rows, an ``EncDec`` module for training.

``backbone_hidden`` and ``head_table`` carry gradients: the train step
differentiates its loss through both (the dense family's attention
through the flash kernel's backward on the card), while serving and the
sampler's statistics call them under ``torch.no_grad()`` or detach the
result.

On a ``(data, model)`` mesh (a ``ShardCtx``) every family's module holds
a rank's shards (``train.step.shard_params``): ``backbone_hidden(...,
ctx)`` gathers them before use (the moe and hybrid families' experts
over the model group, MLA over heads, the mtp rows beside the
backbone's, the expert configs' residual stream S-sharded:
``models/transformer.py``), and ``head_table`` gives this rank's vocab
rows with their feature dim gathered over ``data``
(``rules.gather_head_fd``); a head tied to the embedding is the
embedding's shard.  Serving on a mesh takes the same shards in
``rules.ctx_for_serve``'s mode (tp, or tp_fsdp where ``serve_fsdp``), for
every ported family: the decoder LMs' (``models/transformer.py``) and
the encoder-decoder's (``models/encdec.py``) caches, prefill and
decode.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, lstm_lm, recsys, transformer
from repro_torch.sharding import rules
from repro_torch.utils.misc import resolve_device

PORTED_FAMILIES = ("recsys", "lstm") + transformer.LM_FAMILIES + (
    "encdec",)


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family '{cfg.family}' is not ported yet (only "
            f"{', '.join(PORTED_FAMILIES)})")


def require_mesh_layout(cfg: ArchConfig) -> None:
    """Raise for a config whose parameters this port does not store by the
    reference's rules on a mesh: a family not ported (every ported
    family's layouts are, experts, MLA and multi-token prediction
    included)."""
    _require_ported(cfg)


def require_serve_mesh(cfg: ArchConfig) -> None:
    """The serving family gate on a mesh (``rules.ctx_for_serve``): every
    ported family serves there, so it refuses only a family not ported."""
    _require_ported(cfg)


def init_params(cfg: ArchConfig, gen: torch.Generator,
                device: str | torch.device | None = None,
                max_len: int = encdec.DEFAULT_MAX_LEN, ctx=None):
    """Random weights from ``gen`` on ``device`` — the card unless
    ``device="cpu"``; no device and no CUDA raises.  ``max_len`` sizes an
    encoder-decoder's learned position tables (the other families have
    none).  A mesh ``ctx`` pads an LM's or an encoder-decoder's heads and
    vocab as the reference's ``init_lm`` / ``init_encdec`` do for it; the
    weights are whole."""
    _require_ported(cfg)
    dev = resolve_device(device)
    if cfg.family in transformer.LM_FAMILIES:
        return transformer.init_lm(gen, cfg, dev, ctx=ctx)
    if cfg.family == "encdec":
        return encdec.init_encdec(gen, cfg, dev, max_len=max_len, ctx=ctx)
    if cfg.family == "lstm":
        return lstm_lm.init_lstm_lm(gen, cfg, dev)
    return recsys.init_recsys(gen, cfg, dev)


def init_module(cfg: ArchConfig, gen: torch.Generator,
                device: str | torch.device | None = None,
                max_len: int = encdec.DEFAULT_MAX_LEN,
                ctx=None) -> torch.nn.Module:
    """``init_params`` as an ``nn.Module``, what a ``TrainState`` holds:
    an LM's tree wrapped in a ``StackedLM``, an encoder-decoder's in an
    ``EncDec`` (no copy).  An LM on a mesh ``ctx`` is drawn straight into
    this rank's shards (``transformer.init_lm(..., shard=True)``; its
    ``param_specs`` set as ``train.step.shard_params`` sets them); the
    other families' modules are whole."""
    if cfg.family in transformer.LM_FAMILIES and rules.on_mesh(ctx):
        dev = resolve_device(device)
        model = transformer.StackedLM(cfg, dev, tree=transformer.init_lm(
            gen, cfg, dev, ctx=ctx, shard=True))
        model.param_specs = rules.param_specs_for(
            abstract_params(cfg, ctx=ctx), ctx)
        return model
    params = init_params(cfg, gen, device, max_len, ctx=ctx)
    if cfg.family in transformer.LM_FAMILIES:
        return transformer.StackedLM(cfg, resolve_device(device),
                                     tree=params)
    if cfg.family == "encdec":
        return encdec.EncDec(cfg, resolve_device(device), tree=params)
    return params


#: family -> the module of its params
PARAM_MODULES = {"recsys": recsys.RecsysTower, "lstm": lstm_lm.LSTMLM,
                 **dict.fromkeys(transformer.LM_FAMILIES,
                                 transformer.StackedLM),
                 "encdec": encdec.EncDec}


def abstract_params(cfg: ArchConfig,
                    max_len: int = encdec.DEFAULT_MAX_LEN, ctx=None):
    """The parameters on the ``meta`` device, as the family's module:
    their names, shapes and dtypes, nothing allocated or drawn (an
    encoder-decoder's position tables of ``max_len`` rows; an LM or an
    encoder-decoder padded for a mesh ``ctx`` as ``init_params`` pads
    it)."""
    if cfg.family not in PARAM_MODULES:
        raise NotImplementedError(
            f"abstract params of family '{cfg.family}' are not ported")
    if cfg.family == "encdec":
        return encdec.EncDec(cfg, torch.device("meta"), max_len=max_len,
                             ctx=ctx)
    if cfg.family in transformer.LM_FAMILIES:
        return transformer.StackedLM(cfg, torch.device("meta"), ctx=ctx)
    return PARAM_MODULES[cfg.family](cfg, torch.device("meta"))


def head_name(cfg: ArchConfig) -> str:
    """The parameter name of the class-embedding table: the embedding's
    where the head is tied to it."""
    _require_ported(cfg)
    lm = cfg.family in transformer.LM_FAMILIES + ("encdec",)
    if cfg.tie_embeddings:
        return "embed.table" if lm else "embed_table"
    return "head.w" if lm else "head_w"


def head_table(params, cfg: ArchConfig, ctx=None) -> torch.Tensor:
    """The class-embedding table the sampler/loss/index operate on: the
    parameter itself, so a loss through it reaches its gradient.  On a
    mesh, a module of a rank's shards gives its vocab rows with the
    feature dim gathered over ``data`` (``rules.gather_head_fd``: the
    gradient reduce-scattered back)."""
    _require_ported(cfg)
    if cfg.family in transformer.LM_FAMILIES + ("encdec",):
        top = (encdec._top(params) if cfg.family == "encdec"
               else transformer._top(params))
        head = (top["embed"]["table"]
                if cfg.tie_embeddings or "head" not in top
                else top["head"]["w"])
    else:
        head = params.embed_table if cfg.tie_embeddings else params.head_w
    specs = getattr(params, "param_specs", None)
    if rules.on_mesh(ctx) and specs is not None:
        return rules.gather_head_fd(ctx, head, specs[head_name(cfg)])
    return head


def hidden_width(cfg: ArchConfig) -> int:
    if cfg.family == "recsys":
        return cfg.tower_dims[-1]
    if cfg.family == "lstm":
        return cfg.lstm_units
    return cfg.d_model


def backbone_hidden(params, batch: dict[str, torch.Tensor], cfg: ArchConfig,
                    ctx=None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward to the last hidden layer; flatten (example, feature).

    batch keys: recsys — history (B, H), user_feats (B, F), labels (B,);
    the LMs and lstm — tokens (B, S), labels (B, S); encdec — frames (B,
    Sf, d), tokens (B, S), labels (B, S), Sf apart from S.  aux is the MoE
    layers' load-balance loss (0 for the other families).  With
    ``cfg.mtp`` the multi-token-prediction rows follow the B * S rows in
    the reference's order: ``mtp_hidden``'s h[:, :-1] (predicting token
    t+2) flattened, with labels[:, 2:], so T = B * (2S - 2).  On a mesh
    (``ctx``) the rank's batch block through its shards (an
    encoder-decoder's frames and tokens of the same rows)."""
    _require_ported(cfg)
    if cfg.family in transformer.LM_FAMILIES + ("lstm",):
        if cfg.family == "lstm":
            h, aux = lstm_lm.hidden_states(params, batch["tokens"], cfg,
                                           ctx)
        else:
            h, aux = transformer.hidden_states(params, batch["tokens"], cfg,
                                               ctx)
        d = h.shape[-1]
        hf, labels = h.reshape(-1, d), batch["labels"].reshape(-1)
        if cfg.mtp and cfg.family != "lstm":
            h_mtp = transformer.mtp_hidden(params, h, batch["tokens"], cfg,
                                           ctx)
            hf = torch.cat([hf, h_mtp[:, :-1].reshape(-1, d)], dim=0)
            labels = torch.cat([labels, batch["labels"][:, 2:].reshape(-1)])
        return hf, labels, aux
    if cfg.family == "encdec":
        enc_out = encdec.encode(params, batch["frames"], cfg, ctx)
        h = encdec.decode_train(params, batch["tokens"], enc_out, cfg, ctx)
        return (h.reshape(-1, h.shape[-1]), batch["labels"].reshape(-1),
                torch.zeros((), dtype=torch.float32, device=h.device))
    h, aux = recsys.hidden_states(params, batch["history"],
                                  batch["user_feats"], ctx)
    return h, batch["labels"].reshape(-1), aux
