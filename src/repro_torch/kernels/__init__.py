"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""
from __future__ import annotations

from repro_torch.kernels import block_scores, fused_head, leaf_scores, zstats

#: kernel name -> (wrapper module, its launch counter)
_WRAPPERS = {"zstats": (zstats, "launches"),
             "block_scores": (block_scores, "launches"),
             "leaf_scores": (leaf_scores, "launches"),
             "fused_lse": (fused_head, "fwd_launches"),
             "fused_lse_bwd": (fused_head, "bwd_launches")}


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches since the last ``reset_launch_counts``."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _WRAPPERS.values():
        setattr(mod, attr, 0)
