"""Config registry of the port: the paper's own models, the dense
transformer family (llama3-8b, starcoder2-3b, mistral-nemo-12b, qwen2-72b,
chameleon-34b), the MoE ones (dbrx-132b; deepseek-v3-671b, with MLA and
multi-token prediction), the SSM one (falcon-mamba-7b), the hybrid one
(jamba-v0.1-52b) and the encoder-decoder one (whisper-large-v3): every
architecture the reference registers."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig  # noqa: F401

_MODULES = {
    "chameleon-34b": "chameleon_34b",
    "dbrx-132b": "dbrx_132b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "llama3-8b": "llama3_8b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "ptb-lstm": "ptb_lstm",
    "qwen2-72b": "qwen2_72b",
    "starcoder2-3b": "starcoder2_3b",
    "whisper-large-v3": "whisper_large_v3",
    "youtube-dnn": "youtube_dnn",
}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(_MODULES)
