"""Carry weights and serving state from the JAX package into the port.

Both functions take plain numpy arrays (the JAX side converts with
``np.asarray``), so this module needs neither jax nor ``repro``:

  * ``params_from_jax`` — the reference's recsys params dict
    (``{"embed": {"table"}, "head": {"w"}, "tower": {"w0", "b0", ...}}``)
    into the port's ``RecsysTower``.  Same layouts, so it is a copy.
  * ``index_from_jax`` — a reference ``RetrievalIndex``, field by field,
    into the port's ``RetrievalIndex``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.recsys import RecsysTower
from repro_torch.serve.retrieval import RetrievalIndex
from repro_torch.utils.misc import resolve_device


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
    state = {"embed_table": np_params["embed"]["table"],
             "head_w": np_params["head"]["w"]}
    for name, arr in np_params["tower"].items():
        state[f"tower_{name}"] = arr
    own = model.state_dict()
    if set(state) != set(own):
        raise ValueError(f"param names differ: {sorted(state)} vs "
                         f"{sorted(own)}")
    model.load_state_dict({
        k: torch.from_numpy(np.array(v)).to(device=dev, dtype=own[k].dtype)
        for k, v in state.items()}, assign=True)
    return model


def index_from_jax(np_fields: dict,
                   device: str | torch.device | None = None
                   ) -> RetrievalIndex:
    """Reference ``RetrievalIndex`` fields (numpy tensors plus the ints
    ``n``, ``tp``, ``v_shard``) -> the port's index on ``device``."""
    dev = resolve_device(device)
    if int(np_fields["tp"]) != 1:
        raise NotImplementedError("sharded (tp > 1) indexes are not ported "
                                  "yet")
    tensors = {f: torch.from_numpy(np.array(np_fields[f])).to(dev)
               for f in RetrievalIndex.TENSORS}
    return RetrievalIndex(**tensors, n=int(np_fields["n"]),
                          tp=int(np_fields["tp"]),
                          v_shard=int(np_fields["v_shard"]))
