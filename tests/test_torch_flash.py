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
sums in different orders).  The CUDA kernels are held against the same plain
version on the card by ``chip_smoke.py``; here their dispatch is checked
with the launch stubbed, and the tensor-core kernel's numerics (64-key
tiles, exp2 of scaled fp32 scores, P split into two bf16 halves for the P V
product) are replayed in plain PyTorch against the card's bf16 gate.
"""
import ctypes
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as jflash_raw
from repro.models import layers as JL
from repro_torch import kernels
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as flash_mod
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


def test_build_signatures_hold_both_flash_entry_points():
    """The tensor-core entry point takes q, k, v, o, nine ints (B, Sq, Sk,
    H, KV, hd, hv, s_valid, causal), the scale, the device and the stream;
    the CUDA-core one also its bf16 flag.  Both live in one source.  The
    backward's tensor-core entry takes q, k, v, dout, lse, delta, dq, dk,
    dv, its fold workspace and counters, the same nine ints and scale,
    the plan's chunk, the device and the stream; its CUDA-core entry the
    nine tensors, the ints, the scale and the bf16 flag."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    assert _build.SIGNATURES["flash_attention"] == (
        "flash_attention", "flash_attention_mma_bf16",
        (p,) * 4 + (i,) * 9 + (f, i, p))
    assert _build.SIGNATURES["flash_attention_simt"] == (
        "flash_attention", "flash_attention_fwd",
        (p,) * 4 + (i,) * 9 + (f, i, i, p))
    assert _build.SIGNATURES["flash_attention_bwd"] == (
        "flash_attention_bwd", "flash_attention_bwd_mma_bf16",
        (p,) * 11 + (i,) * 9 + (f, i, i, p))
    assert _build.SIGNATURES["flash_attention_bwd_simt"] == (
        "flash_attention_bwd", "flash_attention_bwd_simt",
        (p,) * 9 + (i,) * 9 + (f, i, i, p))


def _misaligned(shape, dtype):
    """A contiguous tensor whose data starts 2 bytes past a 16-byte line."""
    n = math.prod(shape)
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("dtype,hd,aligned,entry", [
    (torch.bfloat16, 64, True, "flash_attention"),
    (torch.bfloat16, 128, True, "flash_attention"),
    (torch.bfloat16, 16, True, "flash_attention"),
    (torch.float32, 128, True, "flash_attention_simt"),
    (torch.float32, 33, True, "flash_attention_simt"),
    (torch.bfloat16, 33, True, "flash_attention_simt"),
    (torch.bfloat16, 256, True, "flash_attention_simt"),
    (torch.bfloat16, 128, False, "flash_attention_simt"),
])
def test_flash_dispatch_picks_the_entry_point_by_dtype_and_width(
        dtype, hd, aligned, entry, monkeypatch):
    """bf16 with hd (here = hv) a multiple of 16 up to 128 (and 16-byte
    aligned bases, for its 16-byte copies) reaches the tensor-core kernel,
    anything else the CUDA-core one; each launch counts in its own
    counter."""
    calls = []
    monkeypatch.setattr(_build, "check", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=5))
    kernels.reset_launch_counts()
    shapes = ((2, 40, 8, hd), (2, 40, 2, hd), (2, 40, 2, hd))
    make = torch.zeros if aligned else _misaligned
    q, k, v = (make(sh, dtype=dtype) for sh in shapes)
    out = flash_attention(q, k, v, causal=False, s_valid=30)
    assert out.shape == q.shape and out.dtype == dtype
    assert [c[0] for c in calls] == [entry]
    args = calls[0][5:]
    scale = 1.0 / math.sqrt(hd)
    want = (2, 40, 40, 8, 2, hd, hd, 30, 0, scale)
    want += (None, 5) if entry == "flash_attention" else (
        int(dtype == torch.bfloat16), None, 5)
    assert args == want
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == int(entry == "flash_attention")
    assert counts["flash_attention_simt"] == int(
        entry == "flash_attention_simt")
    assert flash_mod.uses_tensor_cores(q, k, v) == (
        entry == "flash_attention")


def _split_p_flash(q, k, v, split):
    """The tensor-core kernel's arithmetic in plain PyTorch, causal: 64-key
    tiles, fp32 scores scaled by log2(e) / sqrt(hd) after the product,
    exp2 against the running max, and P V with P rounded to bf16 either
    once or as P_hi + P_lo (``split``), V bf16, sums in fp32."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(g, 2) for x in (k, v))
    c = torch.tensor(1.4426950408889634 / math.sqrt(hd), dtype=torch.float32)
    m = torch.full((b, s, h), -math.inf)
    l = torch.zeros(b, s, h)
    acc = torch.zeros(b, s, h, hd)
    pos = torch.arange(s)
    for k0 in range(0, s, 64):
        sc = torch.einsum("bqhd,bkhd->bqhk", qf, kf[:, k0:k0 + 64]) * c
        later = pos[k0:k0 + 64][None, :] > pos[:, None]
        sc = sc.masked_fill(later[None, :, None, :], -math.inf)
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp2(m - m_new))
        p = torch.exp2(sc - m_new[..., None])
        l = l * corr + p.sum(-1)
        hi = p.bfloat16().float()
        parts = [hi, (p - hi).bfloat16().float()] if split else [hi]
        pv = sum(torch.einsum("bqhk,bkhd->bqhd", x, vf[:, k0:k0 + 64])
                 for x in parts)
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)


def test_split_p_keeps_bf16_outputs_within_the_chip_gate():
    """chip_smoke.py holds the bf16 kernel to 2^-7 x |plain| + 1e-5 x
    max|plain| per element.  With P as two bf16 halves the kernel's
    arithmetic stays within it (excess ~1e-6 against an allowance of
    ~3e-5); with P rounded to bf16 once, outputs near 0 carry a 2^-9
    relative error of P and miss it by two orders of magnitude."""
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn((1, 256, n, 128), generator=gen).bfloat16()
               for n in (4, 1, 1))
    want = ref.flash_attention_ref(q, k, v, causal=True).float()
    allowed = 1e-5 * float(want.abs().max())

    def excess(got):
        diff = (got.float() - want).abs()
        return float((diff - 2.0 ** -7 * want.abs()).max())

    assert excess(_split_p_flash(q, k, v, split=True)) <= allowed
    assert excess(_split_p_flash(q, k, v, split=False)) > 10 * allowed
