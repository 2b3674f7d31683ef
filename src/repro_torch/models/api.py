"""Family dispatch: one API over the ported backbones (``repro.models.api``).

    init_params(cfg, gen, device)       -> model (with head table)
    backbone_hidden(model, batch, cfg)  -> (h (T, d_h), labels (T,), aux)
    head_table(model, cfg)              -> (n, d_h) class-embedding table

``backbone_hidden`` and ``head_table`` carry gradients: the train step
differentiates its loss through both (the tower's weights and the head
rows), while serving and the sampler's statistics call them under
``torch.no_grad()`` or detach the result.

Only the ``recsys`` family (youtube-dnn) is ported; the others raise
``NotImplementedError`` until their slices land.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import recsys
from repro_torch.utils.misc import resolve_device


def _require_recsys(cfg: ArchConfig) -> None:
    if cfg.family != "recsys":
        raise NotImplementedError(
            f"family '{cfg.family}' is not ported yet (only 'recsys')")


def init_params(cfg: ArchConfig, gen: torch.Generator,
                device: str | torch.device | None = None
                ) -> recsys.RecsysTower:
    """Random weights from ``gen`` on ``device`` — the card unless
    ``device="cpu"``; no device and no CUDA raises."""
    _require_recsys(cfg)
    dev = resolve_device(device)
    return recsys.init_recsys(gen, cfg, dev)


def head_table(model: recsys.RecsysTower, cfg: ArchConfig) -> torch.Tensor:
    """The class-embedding table the sampler/loss/index operate on: the
    parameter itself, so a loss through it reaches its gradient."""
    _require_recsys(cfg)
    if cfg.tie_embeddings:
        return model.embed_table
    return model.head_w


def hidden_width(cfg: ArchConfig) -> int:
    if cfg.family == "recsys":
        return cfg.tower_dims[-1]
    if cfg.family == "lstm":
        return cfg.lstm_units
    return cfg.d_model


def backbone_hidden(model: recsys.RecsysTower, batch: dict[str, torch.Tensor],
                    cfg: ArchConfig
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward to the last hidden layer, differentiable wrt the tower's
    parameters.  recsys batch keys: history (B, H), user_feats (B, F),
    labels (B,)."""
    _require_recsys(cfg)
    h, aux = recsys.hidden_states(model, batch["history"], batch["user_feats"])
    return h, batch["labels"].reshape(-1), aux
