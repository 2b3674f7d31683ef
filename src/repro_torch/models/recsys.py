"""The paper's YouTube retrieval model (Covington et al. 2016 style).

Inputs: the ids of the previously watched videos plus a dense user-feature
vector; tower: averaged watch embeddings ++ user features -> MLP (ReLU
between layers) -> hidden state h; output: softmax over all videos with a
separate item output-embedding table (``head_w``).

Weights keep the reference's layout: the tower's ``w{i}`` are (in, out) and
apply as ``x @ w + b`` (no ``nn.Linear``), so ``convert.params_from_jax``
is a plain copy.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense_init

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class RecsysTower(nn.Module):
    """Parameters: ``embed_table`` (vocab, d_emb), ``head_w`` (vocab, d_h),
    ``tower_w{i}`` (in, out) and ``tower_b{i}`` (out,).

    The constructor only allocates them (``torch.empty``; on the ``meta``
    device nothing at all); ``init_recsys`` draws them and
    ``convert.params_from_jax`` copies them in."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        pd = _DTYPES[cfg.param_dtype]
        self.n_layers = len(cfg.tower_dims)
        shapes = {"embed_table": (cfg.vocab_size, cfg.d_model),
                  "head_w": (cfg.vocab_size, cfg.tower_dims[-1])}
        in_dim = cfg.d_model + cfg.user_feature_dim
        for i, out_dim in enumerate(cfg.tower_dims):
            shapes[f"tower_w{i}"] = (in_dim, out_dim)
            shapes[f"tower_b{i}"] = (out_dim,)
            in_dim = out_dim
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=pd, device=device)))

    def forward(self, history: torch.Tensor,
                user_feats: torch.Tensor) -> torch.Tensor:
        """history: (B, H) item ids; user_feats: (B, F) -> h (B, d_h)."""
        watch = torch.mean(self.embed_table[history], dim=1)
        x = torch.cat([watch, user_feats.to(watch.dtype)], dim=-1)
        for i in range(self.n_layers):
            x = x @ getattr(self, f"tower_w{i}") + getattr(self,
                                                           f"tower_b{i}")
            if i < self.n_layers - 1:
                x = torch.relu(x)
        return x


def init_recsys(gen: torch.Generator, cfg: ArchConfig,
                device: torch.device) -> RecsysTower:
    """Random weights from ``gen``: embed and head std 0.05, tower weights
    std ``1/sqrt(fan_in)``, tower biases 0."""
    model = RecsysTower(cfg, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("tower_b"):
                p.zero_()
            else:
                scale = 0.05 if name in ("embed_table", "head_w") else None
                p.copy_(dense_init(gen, p.shape, p.dtype, device,
                                   scale=scale))
    return model


def hidden_states(model: RecsysTower, history: torch.Tensor,
                  user_feats: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """history: (B, H) item ids; user_feats: (B, F).  Returns (h (B, d), 0)."""
    h = model(history, user_feats)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)
