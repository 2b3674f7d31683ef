"""The paper's PTB model (``repro.models.lstm_lm``): Zaremba et al. (2014)
"medium regularized LSTM" at 200 units per layer (the paper's §4.1.1
modification), dropout omitted as in the reference.

Parameters keep the reference's names and layouts, flattened: ``embed_table``
(V, u), ``head_w`` (V, u), and per layer i ``lstm{i}_kernel`` (u, 4u),
``lstm{i}_recurrent`` (u, 4u) and ``lstm{i}_bias`` (4u,), gates ordered
i, f, g, o, so ``convert.params_from_jax`` is a plain copy.  The reference
``lax.scan``s each layer over the sequence; here a Python loop runs its
steps, each a handful of small tensor ops under autograd (the JAX package
computes them outside any Pallas kernel, so none is a kernel here).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import _pdtype, dense_init

Tensor = torch.Tensor


class LSTMLM(nn.Module):
    """The embedding table, the softmax head and ``cfg.lstm_layers`` LSTM
    layers of ``cfg.lstm_units`` units.

    The constructor only allocates the parameters (``torch.empty``; on the
    ``meta`` device nothing at all); ``init_lstm_lm`` draws them and
    ``convert.params_from_jax`` copies them in."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        pd = _pdtype(cfg)
        u = cfg.lstm_units
        self.n_layers = cfg.lstm_layers
        shapes = {"embed_table": (cfg.vocab_size, u),
                  "head_w": (cfg.vocab_size, u)}
        for i in range(self.n_layers):
            shapes[f"lstm{i}_kernel"] = (u, 4 * u)
            shapes[f"lstm{i}_recurrent"] = (u, 4 * u)
            shapes[f"lstm{i}_bias"] = (4 * u,)
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=pd, device=device)))

    def layer(self, i: int) -> dict[str, Tensor]:
        """Layer i's parameters under the reference's names."""
        return {k: getattr(self, f"lstm{i}_{k}")
                for k in ("kernel", "recurrent", "bias")}

    def forward(self, tokens: Tensor) -> Tensor:
        """tokens: (B, S) ids -> h: (B, S, u)."""
        b = tokens.shape[0]
        u = self.embed_table.shape[1]
        xs = list(self.embed_table[tokens].unbind(1))  # S x (B, u)
        for i in range(self.n_layers):
            p = self.layer(i)
            h = c = xs[0].new_zeros((b, u))
            for s, x in enumerate(xs):
                h, c = _cell(p, x, h, c)
                xs[s] = h
        return torch.stack(xs, dim=1)


def init_lstm_lm(gen: torch.Generator, cfg: ArchConfig,
                 device: torch.device) -> LSTMLM:
    """Random weights from ``gen``, in the reference's order and scales:
    embed and head std 0.05, each layer's kernel then recurrent std
    ``1/sqrt(u)`` (``dense_init``'s default), biases 0."""
    model = LSTMLM(cfg, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("_bias"):
                p.zero_()
            else:
                scale = 0.05 if name in ("embed_table", "head_w") else None
                p.copy_(dense_init(gen, p.shape, p.dtype, device,
                                   scale=scale))
    return model


def _cell(p: dict[str, Tensor], x: Tensor, h: Tensor, c: Tensor
          ) -> tuple[Tensor, Tensor]:
    """One LSTM step: gates split as i, f, g, o; the forget gate's +1
    bias."""
    gates = x @ p["kernel"] + h @ p["recurrent"] + p["bias"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def hidden_states(model: LSTMLM, tokens: Tensor, cfg: ArchConfig
                  ) -> tuple[Tensor, Tensor]:
    """tokens: (B, S) -> (h: (B, S, units), aux = 0)."""
    h = model(tokens)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)
