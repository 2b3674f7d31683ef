"""Checkpointable input pipeline, unsharded (``repro.data.pipeline``).

The iterator is a pure function of (seed, step): restoring ``state_dict()``
resumes the exact batch sequence.  Each batch gets its own generator,
seeded from (seed, step) as the reference folds the step into its key.
The mesh (data-sharded) placement arrives with the multi-device slice.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.synthetic import SyntheticRecsys
from repro_torch.utils.misc import fold_in, resolve_device


class ShardedBatchIterator:
    def __init__(self, sample_fn: Callable[[torch.Generator], dict],
                 ctx=None, seed: int = 0, start_step: int = 0,
                 device: str | torch.device | None = None):
        if ctx is not None and getattr(ctx, "mesh", None) is not None:
            raise NotImplementedError(
                "mesh batch placement is not ported yet (ROADMAP.md A17)")
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
        return self._sample_fn(gen)

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
    ``device="cpu"``).  Only the recsys family is ported; ``seq_len`` is
    unused by it."""
    if cfg.family != "recsys":
        raise NotImplementedError(
            f"synthetic data for family '{cfg.family}' is not ported yet "
            "(only 'recsys')")
    dev = resolve_device(device)
    task = SyntheticRecsys(n_items=cfg.vocab_size,
                           history_len=cfg.history_len,
                           user_feature_dim=cfg.user_feature_dim, seed=seed,
                           device=str(dev))
    return ShardedBatchIterator(lambda g: task.sample_batch(g, global_batch),
                                ctx, seed=seed, device=dev)
