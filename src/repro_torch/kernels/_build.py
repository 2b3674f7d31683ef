"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<source>.cu`` exposes one plain C function per kernel (the
fused head's, the midx scores' and the attention backward's sources hold
two each, the attention forward's four: each route with and without its
log-sum-exp output) and is compiled on first use, by ``nvcc`` alone (no PyTorch headers, so a
build takes seconds), into ``build/repro_torch/<source>-<hash>.so`` under the
repository root, where the hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags: an edited source or header rebuilds, an
unchanged one loads the cached library.  ``build_all`` starts one ``nvcc``
per source, all at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module of the
port on a machine without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: kernel -> (source stem, C function, argtypes); every function returns a
#: cudaError_t.
SIGNATURES = {
    "zstats": ("zstats", "zstats_f32", (_P, _P, _I, _I, _I, _I, _I, _P)),
    "block_scores": ("block_scores", "block_scores_f32",
                     (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I,
                      _I, _P)),
    "leaf_scores": ("leaf_scores", "leaf_scores_f32",
                    (_P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _P)),
    "fused_lse": ("fused_head", "fused_lse_f32",
                  (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    "fused_lse_bwd": ("fused_head", "fused_lse_bwd_f32",
                      (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _L, _I, _P)),
    "rff_features": ("rff_features", "rff_features_f32",
                     (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I,
                      _P)),
    "midx_pair_masses": ("midx_scores", "midx_pair_masses_f32",
                         (_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _I,
                          _P)),
    "midx_list_masses": ("midx_scores", "midx_list_masses_f32",
                         (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I,
                          _I, _I, _I, _P)),
    "midx_member_scores": ("midx_scores", "midx_member_scores_f32",
                           (_P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P)),
    "flash_attention": ("flash_attention", "flash_attention_mma_bf16",
                        (_P,) * 4 + (_I,) * 9 + (_F, _I, _P)),
    "flash_attention_simt": ("flash_attention", "flash_attention_fwd",
                             (_P,) * 4 + (_I,) * 9 + (_F, _I, _I, _P)),
    "flash_attention_lse": ("flash_attention",
                            "flash_attention_mma_bf16_lse",
                            (_P,) * 5 + (_I,) * 9 + (_F, _I, _P)),
    "flash_attention_simt_lse": ("flash_attention", "flash_attention_fwd_lse",
                                 (_P,) * 5 + (_I,) * 9 + (_F, _I, _I, _P)),
    "flash_attention_bwd": ("flash_attention_bwd",
                            "flash_attention_bwd_mma_bf16",
                            (_P,) * 11 + (_I,) * 9 + (_F, _I, _I, _P)),
    "flash_attention_bwd_simt": ("flash_attention_bwd",
                                 "flash_attention_bwd_simt",
                                 (_P,) * 9 + (_I,) * 9 + (_F, _I, _I, _P)),
    "sampled_loss": ("sampled_loss", "sampled_loss_fwd",
                     (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I,
                      _I, _I, _I, _I, _I, _P)),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def source(name: str) -> Path:
    """The ``.cu`` file that holds kernel ``name``."""
    return _CSRC / f"{SIGNATURES[name][0]}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """The shared library of kernel ``name``'s source."""
    src = source(name)
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:16]}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source in parallel.

    Returns source stem -> compiler log (ptxas register/shared-memory lines;
    empty for a library found in the cache).  Raises on a failed build."""
    names = list(SIGNATURES if names is None else names)
    logs: dict[str, str] = {}
    procs = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for stem, name in {SIGNATURES[n][0]: n for n in names}.items():
        out = library_path(name)
        if out.exists():
            logs[stem] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's loaded library (built first if missing), argtypes set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _, fn_name, argtypes = SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(name: str, t: torch.Tensor, ndim: int,
          dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is what the kernels take: a contiguous CUDA tensor
    of ``ndim`` dims and type ``dtype`` — fp32 for values (only
    ``flash_attention`` and its backward, ``sampled_loss``, the fused head
    and the midx stage-1 entries also take bf16), int32 for row ids."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(name: str, *args) -> None:
    """Call the kernel's C entry point; raise on a non-zero cudaError_t."""
    fn = getattr(load(name), SIGNATURES[name][1])
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: "
                           f"cudaError_t {err}")
