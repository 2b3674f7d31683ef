"""Deterministic synthetic tasks with learnable structure
(``repro.data.synthetic``): the recsys task of the paper's YouTube setting.

  * SyntheticRecsys — ground-truth two-tower model: user vector u, items W*;
    label ~ softmax(W* u / tau); features are noisy views of u.

Tables and batches are drawn on ``device`` from the port's own seeded
``torch.Generator``s; the reference draws them with ``jax.random``, so the
two agree in distribution, not bit for bit.  ``SyntheticLM`` arrives with
the LSTM slice.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.utils.misc import resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticRecsys:
    n_items: int
    d_latent: int = 16
    history_len: int = 3
    user_feature_dim: int = 64
    temperature: float = 16.0
    noise: float = 0.2
    seed: int = 0
    device: str | None = None

    @functools.cached_property
    def _dev(self) -> torch.device:
        return resolve_device(self.device)

    @functools.cached_property
    def _items(self) -> torch.Tensor:
        """Unit-norm item vectors W* (n_items, d_latent), drawn once."""
        gen = torch.Generator(self._dev).manual_seed(self.seed)
        w = torch.randn((self.n_items, self.d_latent), generator=gen,
                        device=self._dev)
        return w / torch.linalg.norm(w, dim=-1, keepdim=True)

    def _users(self, gen: torch.Generator, n: int) -> torch.Tensor:
        u = torch.randn((n, self.d_latent), generator=gen, device=self._dev)
        return u / torch.linalg.norm(u, dim=-1, keepdim=True)

    def sample_batch(self, gen: torch.Generator, batch: int
                     ) -> dict[str, torch.Tensor]:
        """history (B, H) and labels (B,) int64 item ids, user_feats (B, F)
        fp32, all on the task's device."""
        u = self._users(gen, batch)
        probs = torch.softmax(self.temperature * (u @ self._items.T), dim=-1)
        labels = torch.multinomial(probs, 1, generator=gen)[:, 0]
        # History: more draws from the same user's distribution.
        hist = torch.multinomial(probs, self.history_len, replacement=True,
                                 generator=gen)
        # User features: noisy view of u, padded to user_feature_dim.
        noise = self.noise * torch.randn(u.shape, generator=gen,
                                         device=self._dev)
        pad = 0.1 * torch.randn((batch,
                                 self.user_feature_dim - self.d_latent),
                                generator=gen, device=self._dev)
        return {"history": hist, "user_feats": torch.cat([u + noise, pad], -1),
                "labels": labels}

    def bayes_loss(self, n_users: int = 512) -> float:
        """Cross entropy of the ground-truth model (loss floor)."""
        gen = torch.Generator(self._dev).manual_seed(2)
        u = self._users(gen, n_users)
        logp = torch.log_softmax(self.temperature * (u @ self._items.T), -1)
        return float(-torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1)))
