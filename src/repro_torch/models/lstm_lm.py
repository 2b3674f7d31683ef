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

On a ``(data, model)`` mesh a rank's ``LSTMLM`` holds its shards by the
reference's rules (``train.step.shard_params`` sets ``param_specs``): the
embedding and the head ``(V, Fd)``, their rows over ``model`` (padded to
a multiple of tp) and their features over ``data``.  The cells' kernel,
recurrent and bias stay whole on every rank in every mode, and are used
as they are: the reference's ``lstm<i>/kernel`` rule needs a path
component before ``lstm<i>``, which the tree's top-level layers lack.
``hidden_states(..., ctx)`` takes the embedding through
``rules.compute_view``: under TP it is looked up vocab-parallel
(``layers.embed_rows`` over the model group) and every model rank runs
the same cells on its data row's tokens; in pure_fsdp it is whole.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import _pdtype, dense_init, embed_rows
from repro_torch.sharding import rules

Tensor = torch.Tensor


class LSTMLM(nn.Module):
    """The embedding table, the softmax head and ``cfg.lstm_layers`` LSTM
    layers of ``cfg.lstm_units`` units.

    The constructor only allocates the parameters (``torch.empty``; on the
    ``meta`` device nothing at all); ``init_lstm_lm`` draws them and
    ``convert.params_from_jax`` copies them in."""

    #: {name: spec} of a mesh rank's shards; None: every parameter whole
    param_specs: dict | None = None

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

    def forward(self, tokens: Tensor, ctx=None) -> Tensor:
        """tokens: (B, S) ids -> h: (B, S, u); on a mesh the rank's rows
        through its shards (the module docstring)."""
        b = tokens.shape[0]
        table, group = self.embed_table, None
        if rules.on_mesh(ctx):
            spec = self.param_specs["embed_table"]
            table = rules.compute_view(table, spec, ctx)
            group = rules.vocab_group(spec, ctx)
        u = table.shape[1]
        xs = list(embed_rows(table, tokens, group).unbind(1))  # S x (B, u)
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


def hidden_states(model: LSTMLM, tokens: Tensor, cfg: ArchConfig,
                  ctx=None) -> tuple[Tensor, Tensor]:
    """tokens: (B, S) -> (h: (B, S, units), aux = 0); on a mesh (``ctx``)
    the rank's batch rows through its shards."""
    h = model(tokens, ctx)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)
