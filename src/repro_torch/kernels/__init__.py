"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""
from __future__ import annotations

from repro_torch.kernels import block_scores, leaf_scores, zstats

_WRAPPERS = {"zstats": zstats, "block_scores": block_scores,
             "leaf_scores": leaf_scores}


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches since the last ``reset_launch_counts``."""
    return {name: mod.launches for name, mod in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS.values():
        mod.launches = 0
