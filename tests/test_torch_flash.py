"""The port's flash attention (``repro_torch.kernels.ops.flash_attention``
and ``models.layers.chunked_attention``) against the JAX package's.

On the CPU the port's ``ops.flash_attention`` runs its plain version
(``ref.flash_attention_ref``: online softmax over 128-key chunks, query
head h reading KV head h // group) and
the reference's runs the Pallas kernel in interpret mode; both get the same
numpy inputs, at the shapes of ``tests/test_kernels_pallas.py``'s flash
test (S = 64, 100 and 33), causal and not.  Tolerances: fp32 1e-5 (rtol
and atol; both compute in fp32 and differ in summation order), bf16 2e-2
as the reference's own test states (the outputs round to bf16 after fp32
sums in different orders).  The CUDA kernel is held against the same plain
version on the card by ``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as jflash_raw
from repro.models import layers as JL
from repro_torch import kernels
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L

torch.set_num_threads(1)

SHAPES = [(1, 64, 2, 2, 16), (2, 100, 4, 2, 16), (1, 33, 2, 1, 32),
          (2, 33, 8, 2, 16)]
FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


@functools.partial(jax.jit, static_argnames=("causal",))
def _jflash(q, k, v, causal):
    return jops.flash_attention(q, k, v, causal=causal, q_tile=32,
                                kv_tile=32)


@functools.partial(jax.jit, static_argnames=("causal", "chunk", "q_offset"))
def _jchunked(q, k, v, causal, chunk, q_offset=0):
    return JL.chunked_attention(q, k, v, causal=causal, chunk=chunk,
                                q_offset=q_offset)


def _qkv(b, s, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, s, h, hd)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(b, s, kv, hd)) * 0.5).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    return q, k, v


def _to_torch(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _to_jax(*xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kv,hd", SHAPES)
def test_flash_matches_jax_kernel_and_chunked_fp32(b, s, h, kv, hd, causal):
    q, k, v = _qkv(b, s, h, kv, hd)
    got = ops.flash_attention(*_to_torch(q, k, v), causal=causal)
    assert got.shape == (b, s, h, hd) and got.dtype == torch.float32
    want = np.asarray(_jflash(*_to_jax(q, k, v), causal))
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    chunked = np.asarray(_jchunked(*_to_jax(q, k, v), causal, 16))
    np.testing.assert_allclose(got.numpy(), chunked, **FP32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kv,hd", SHAPES[:3])
def test_flash_matches_jax_kernel_bf16(b, s, h, kv, hd, causal):
    q, k, v = _qkv(b, s, h, kv, hd, seed=1)
    got = ops.flash_attention(*_to_torch(q, k, v, dtype=torch.bfloat16),
                              causal=causal)
    assert got.dtype == torch.bfloat16
    want = _jflash(*_to_jax(q, k, v, dtype=jnp.bfloat16), causal)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_masks_keys_past_s_valid_like_the_pallas_kernel(causal):
    """The Pallas kernel's ``s_valid`` (rows the wrapper padded) against the
    plain version's, on a (B*H, S, hd) layout with 14 masked keys."""
    q, k, v = _qkv(1, 64, 2, 2, 16, seed=2)
    bh = lambda x: np.ascontiguousarray(  # noqa: E731
        np.moveaxis(x, 2, 1).reshape(2, 64, 16))
    want = jflash_raw(*_to_jax(bh(q), bh(k), bh(v)), causal=causal,
                      q_tile=32, kv_tile=32, s_valid=50, interpret=True)
    got = ref.flash_attention_ref(*_to_torch(q, k, v), causal=causal,
                                  s_valid=50)
    np.testing.assert_allclose(bh(got.numpy()), np.asarray(want), **FP32)


@pytest.mark.parametrize("q_offset,sq,sk,chunk", [(0, 12, 12, 5),
                                                  (7, 5, 12, 4),
                                                  (3, 9, 12, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_jax(q_offset, sq, sk, chunk, causal):
    """The port's pure-tensor chunked attention, with a query offset, a
    chunk that does not divide Sk and hv != hd (MLA's case)."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, sk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, sk, 2, 8)).astype(np.float32)
    want = np.asarray(_jchunked(*_to_jax(q, k, v), causal, chunk, q_offset))
    got = L.chunked_attention(*_to_torch(q, k, v), causal=causal,
                              chunk=chunk, q_offset=q_offset)
    assert got.shape == (2, sq, 4, 8)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


def test_reference_scales_bf16_queries_in_fp32():
    """``chunked_attention``'s ``q * scale`` takes a numpy-float64 scale,
    which promotes a bf16 q to fp32 before the multiply: the same order as
    the Pallas kernel's (and the CUDA kernel's) cast-then-scale."""
    q = jnp.asarray(np.random.default_rng(4).normal(size=(64,)),
                    jnp.bfloat16)
    scale = 1.0 / np.sqrt(16)
    assert (q * scale).dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(q * scale),
                                  np.asarray(q.astype(jnp.float32) * scale))


def test_cuda_wrapper_refuses_cpu_tensors_and_other_dtypes():
    kernels.reset_launch_counts()
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention(q, q[:, :, :1], q[:, :, :1])
    with pytest.raises(TypeError, match="float16"):
        flash_attention(q.half(), q.half(), q.half())
    assert kernels.launch_counts()["flash_attention"] == 0
