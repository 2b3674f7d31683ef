"""Carry weights and serving state from the JAX package into the port.

Both functions take plain numpy arrays (the JAX side converts with
``np.asarray``), so this module needs neither jax nor ``repro``:

  * ``params_from_jax`` — the reference's recsys params dict
    (``{"embed": {"table"}, "head": {"w"}, "tower": {"w0", "b0", ...}}``)
    into the port's ``RecsysTower``.  Same layouts, so it is a copy.
  * ``index_from_jax`` — a reference ``RetrievalIndex``, field by field,
    into the port's ``RetrievalIndex``.
  * ``train_state_from_jax`` — a reference ``TrainState`` (params, the
    ``chain(clip, adamw)`` state, the sampler's carried state and the step)
    into the port's ``TrainState``, so both packages can take a step from
    one state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.samplers import SamplerState
from repro_torch.models.recsys import RecsysTower
from repro_torch.serve.retrieval import RetrievalIndex
from repro_torch.train.step import TrainState
from repro_torch.utils.misc import resolve_device


def _flat_params(np_params: dict) -> dict:
    """Reference recsys param tree -> the port's parameter names."""
    flat = {"embed_table": np_params["embed"]["table"],
            "head_w": np_params["head"]["w"]}
    for name, arr in np_params["tower"].items():
        flat[f"tower_{name}"] = arr
    return flat


def _tensor(arr, dev: torch.device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(arr)).to(device=dev, dtype=dtype)


def params_from_jax(np_params: dict, cfg: ArchConfig,
                    device: str | torch.device | None = None) -> RecsysTower:
    """Reference recsys params (numpy leaves) -> the port's module on
    ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    if cfg.family != "recsys":
        raise NotImplementedError(
            f"family '{cfg.family}' is not ported yet (only 'recsys')")
    # Built on the meta device, so nothing is allocated or drawn before
    # the copies are assigned.
    model = RecsysTower(cfg, torch.device("meta"))
    state = _flat_params(np_params)
    own = model.state_dict()
    if set(state) != set(own):
        raise ValueError(f"param names differ: {sorted(state)} vs "
                         f"{sorted(own)}")
    model.load_state_dict({k: _tensor(v, dev, own[k].dtype)
                           for k, v in state.items()}, assign=True)
    return model


def train_state_from_jax(np_params: dict, np_opt_state, np_sampler: dict,
                         step: int, cfg: ArchConfig,
                         device: str | torch.device | None = None
                         ) -> TrainState:
    """A reference ``TrainState`` as numpy -> the port's, on ``device``.

    np_params: the recsys param tree; np_opt_state: the state of
    ``make_optimizer("adamw", ...)``, i.e. ``((), {"m": tree, "v": tree,
    "step": int32})``; np_sampler: ``{"stats": {...}, "const": {...}}`` of
    the sampler's carried state (``{}`` dicts for none); step: the train
    step count."""
    dev = resolve_device(device)
    model = params_from_jax(np_params, cfg, device=dev)
    clip_state, adam = np_opt_state
    if clip_state != () or set(adam) != {"m", "v", "step"}:
        raise NotImplementedError(
            "only the chain(clip_by_global_norm, adamw) state is carried")
    opt_state = ((), {
        "m": {k: _tensor(v, dev) for k, v in
              _flat_params(adam["m"]).items()},
        "v": {k: _tensor(v, dev) for k, v in
              _flat_params(adam["v"]).items()},
        "step": _tensor(adam["step"], dev, torch.int32)})
    sampler_state = SamplerState(
        stats={k: _tensor(v, dev) for k, v in np_sampler["stats"].items()},
        const={k: _tensor(v, dev) for k, v in np_sampler["const"].items()})
    return TrainState(params=model, opt_state=opt_state,
                      sampler_state=sampler_state, step=int(step))


def index_from_jax(np_fields: dict,
                   device: str | torch.device | None = None
                   ) -> RetrievalIndex:
    """Reference ``RetrievalIndex`` fields (numpy tensors plus the ints
    ``n``, ``tp``, ``v_shard``) -> the port's index on ``device``."""
    dev = resolve_device(device)
    if int(np_fields["tp"]) != 1:
        raise NotImplementedError("sharded (tp > 1) indexes are not ported "
                                  "yet")
    tensors = {f: _tensor(np_fields[f], dev) for f in RetrievalIndex.TENSORS}
    return RetrievalIndex(**tensors, n=int(np_fields["n"]),
                          tp=int(np_fields["tp"]),
                          v_shard=int(np_fields["v_shard"]))
