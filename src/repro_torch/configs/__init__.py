"""Config registry of the port: the paper's own models and llama3-8b.

The reference registers the other assigned architectures as well; each
joins here with the slice that ports its family."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig  # noqa: F401

_MODULES = {
    "llama3-8b": "llama3_8b",
    "ptb-lstm": "ptb_lstm",
    "youtube-dnn": "youtube_dnn",
}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(_MODULES)
