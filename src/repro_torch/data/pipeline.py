"""Checkpointable input pipeline (``repro.data.pipeline``).

The iterator is a pure function of (seed, step): restoring ``state_dict()``
resumes the exact batch sequence.  Each batch gets its own generator,
seeded from (seed, step) as the reference folds the step into its key.

On a ``(data, model)`` mesh every rank draws the same GLOBAL batch (a pure
function of (seed, step), so the sequence is the same at any mesh shape)
and keeps its data block of the rows (``sharding.rules.batch_rows``: data
rank i holds rows [i B/dp, (i + 1) B/dp), the reference's device order);
the ranks of one model column hold the same rows.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.synthetic import SyntheticLM, SyntheticRecsys
from repro_torch.models import layers as L
from repro_torch.sharding import rules
from repro_torch.utils.misc import fold_in, resolve_device

#: the families whose batches are ``SyntheticLM`` token chains
TOKEN_FAMILIES = ("lstm", "dense", "moe", "ssm", "hybrid")


class ShardedBatchIterator:
    def __init__(self, sample_fn: Callable[[torch.Generator], dict],
                 ctx=None, seed: int = 0, start_step: int = 0,
                 device: str | torch.device | None = None):
        self._ctx = ctx if rules.on_mesh(ctx) else None
        self._sample_fn = sample_fn
        self._device = resolve_device(device)
        self._seed = seed
        self._step = start_step

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        gen = torch.Generator(self._device).manual_seed(
            fold_in(self._seed, self._step))
        self._step += 1
        batch = self._sample_fn(gen)
        if self._ctx is None:
            return batch
        return {k: rules.batch_rows(x, self._ctx).contiguous()
                for k, x in batch.items()}

    # -- checkpointable state --------------------------------------------
    def state_dict(self) -> dict[str, Any]:
        return {"seed": self._seed, "step": self._step}

    def load_state(self, state: dict[str, Any]) -> None:
        self._seed = int(state["seed"])
        self._step = int(state["step"])


def batch_iterator_for(cfg: ArchConfig, ctx, global_batch: int,
                       seq_len: int, seed: int = 0,
                       device: str | torch.device | None = None
                       ) -> ShardedBatchIterator:
    """Synthetic batches for ``cfg`` on ``device`` (the card unless
    ``device="cpu"``): recsys (``seq_len`` unused); the lstm and decoder
    LMs, ``SyntheticLM`` token sequences of ``seq_len``; encdec, such a
    batch plus ``frames`` (B, seq_len, d_model) drawn normal from the
    batch's generator in ``cfg.dtype`` (the frontend stub's embeddings;
    the reference's encdec branch).  Frames and tokens of two lengths
    come from a ``ShardedBatchIterator`` over a sample function of the
    caller's.  On a mesh each rank gets its block of every global batch
    under ``cfg``'s own mode (``rules.ctx_for_train``, as ``fit`` takes
    it): over ``data``, or data x model, data-major, in ``pure_fsdp``."""
    if rules.on_mesh(ctx):
        ctx = rules.ctx_for_train(ctx.mesh, cfg)
    if cfg.family not in ("recsys", "encdec") + TOKEN_FAMILIES:
        raise NotImplementedError(
            f"synthetic data for family '{cfg.family}' is not ported "
            f"(only {', '.join(('recsys', 'encdec') + TOKEN_FAMILIES)})")
    dev = resolve_device(device)
    if cfg.family == "encdec":
        lm = SyntheticLM(vocab_size=cfg.vocab_size, seed=seed,
                         device=str(dev))

        def sample(g: torch.Generator) -> dict:
            b = lm.sample_batch(g, global_batch, seq_len)
            frames = torch.randn((global_batch, seq_len, cfg.d_model),
                                 generator=g, device=dev)
            return {"frames": frames.to(L._dtype(cfg)), **b}

        return ShardedBatchIterator(sample, ctx, seed=seed, device=dev)
    if cfg.family in TOKEN_FAMILIES:
        lm = SyntheticLM(vocab_size=cfg.vocab_size, seed=seed,
                         device=str(dev))
        return ShardedBatchIterator(
            lambda g: lm.sample_batch(g, global_batch, seq_len), ctx,
            seed=seed, device=dev)
    task = SyntheticRecsys(n_items=cfg.vocab_size,
                           history_len=cfg.history_len,
                           user_feature_dim=cfg.user_feature_dim, seed=seed,
                           device=str(dev))
    return ShardedBatchIterator(lambda g: task.sample_batch(g, global_batch),
                                ctx, seed=seed, device=dev)
