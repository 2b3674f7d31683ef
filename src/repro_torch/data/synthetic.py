"""Deterministic synthetic tasks with learnable structure
(``repro.data.synthetic``):

  * SyntheticLM — order-1 Markov language with low-rank transition logits
    P(next|prev) ∝ exp(<E[next], C[prev]> / sqrt(rank)): an LSTM can learn
    it, and the achievable cross entropy is the entropy of the chain.
  * SyntheticRecsys — ground-truth two-tower model: user vector u, items W*;
    label ~ softmax(W* u / tau); features are noisy views of u.

Tables and batches are drawn on ``device`` from the port's own seeded
``torch.Generator``s; the reference draws them with ``jax.random``, so the
two agree in distribution, not bit for bit (``SyntheticLM`` also takes the
reference's tables, so a test can compare the chains themselves).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.utils.misc import resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    rank: int = 16
    temperature: float = 1.0
    seed: int = 0
    device: str | None = None
    #: (e, c), each (vocab_size, rank); None draws them from ``seed``
    tables: tuple[torch.Tensor, torch.Tensor] | None = None

    @functools.cached_property
    def _dev(self) -> torch.device:
        return resolve_device(self.device)

    @functools.cached_property
    def _tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The next-token table E and the context table C."""
        if self.tables is not None:
            return tuple(x.to(self._dev, torch.float32) for x in self.tables)
        gen = torch.Generator(self._dev).manual_seed(self.seed)
        shape = (self.vocab_size, self.rank)
        return (torch.randn(shape, generator=gen, device=self._dev),
                torch.randn(shape, generator=gen, device=self._dev))

    def transition_logits(self, prev: torch.Tensor) -> torch.Tensor:
        """prev: (N,) ids -> (N, vocab_size) logits of the next token."""
        e, c = self._tables
        scale = self.temperature / math.sqrt(self.rank)
        return (c[prev] @ e.T) * scale

    def sample_batch(self, gen: torch.Generator, batch: int, seq_len: int
                     ) -> dict[str, torch.Tensor]:
        """tokens and labels (batch, seq_len) int64 on the task's device;
        labels are the next-token targets (one extra step is drawn)."""
        prev = torch.randint(0, self.vocab_size, (batch,), generator=gen,
                             device=self._dev)
        first, seq = prev, []
        for _ in range(seq_len):
            probs = torch.softmax(self.transition_logits(prev), dim=-1)
            prev = torch.multinomial(probs, 1, generator=gen)[:, 0]
            seq.append(prev)
        labels = torch.stack(seq, dim=1)
        tokens = torch.cat([first[:, None], labels[:, :-1]], dim=1)
        return {"tokens": tokens, "labels": labels}

    def chain_entropy(self, n_prev: int = 256,
                      prev: torch.Tensor | None = None) -> float:
        """Monte-Carlo estimate of the per-token entropy (the loss floor)
        over ``prev`` ids, by default ``n_prev`` drawn from seed 1."""
        if prev is None:
            gen = torch.Generator(self._dev).manual_seed(1)
            prev = torch.randint(0, self.vocab_size, (n_prev,),
                                 generator=gen, device=self._dev)
        logp = torch.log_softmax(self.transition_logits(prev), dim=-1)
        return float(-torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1)))


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
