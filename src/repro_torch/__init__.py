"""PyTorch/CUDA port of the ``repro`` package (one H100, CUDA C++ kernels).

Module paths and function names mirror ``src/repro/`` so each function's
counterpart is found under the same name.  The port imports torch and
numpy only — never jax, and nothing of ``repro``.

Entry points that CREATE tensors (``models.api.init_params``,
``serve.retrieval.build_index`` from numpy, ``convert.*``,
``serve.server.ServingEngine``) run on the card unless the caller passes
``device="cpu"``; with no device given and no CUDA present they raise.
Functions that TAKE tensors run on those tensors' device.

fp32 matrix products and convolutions are kept in full fp32 (TF32 OFF):
the retrieval path's exactness check holds the leaf kernel's fp32 dots
against a cuBLAS fp32 matmul, and TF32's ~3 decimal digits would break it.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
