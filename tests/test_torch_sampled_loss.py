"""The port's fused sampled-softmax loss (``repro_torch.kernels.ops.
sampled_loss``) against the JAX package's.

On the CPU the port's ``ops.sampled_loss`` runs its plain version
(``ref.sampled_loss_ref``) and the reference's runs the Pallas kernel in
interpret mode (its wrapper pads T and m to the tiles, padded negatives
with logq = 1e30); both get the same numpy inputs, on ragged T and m and
with m_total != m.  Tolerance 1e-5 (rtol and atol) in fp32 and in bf16:
both sides upcast bf16 inputs to fp32 exactly and sum in fp32, in
different orders, and the loss is fp32.  The CUDA kernel is held against
the same plain version on the card by ``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.kernels import ops, ref
from repro_torch.kernels.sampled_loss import sampled_loss

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@functools.partial(jax.jit, static_argnames=("m_total",))
def _jloss(h, w, logq, pos, m_total):
    return jops.sampled_loss(h, w, logq, pos, m_total=m_total)


def _inputs(t, d, m, seed=0):
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=(t, d)) * 0.3).astype(np.float32)
    w = (rng.normal(size=(m, d)) * 0.3).astype(np.float32)
    z = rng.normal(size=(m,))
    logq = (z - np.log(np.sum(np.exp(z)))).astype(np.float32)
    pos = rng.normal(size=(t,)).astype(np.float32)
    return h, w, logq, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d,m,m_total", [(32, 16, 64, 64), (37, 48, 70, 70),
                                           (128, 8, 8, 1000),
                                           (5, 32, 200, 256), (3, 7, 1, 5),
                                           (130, 24, 129, 2048)])
def test_sampled_loss_matches_jax(t, d, m, m_total, dtype):
    h, w, logq, pos = _inputs(t, d, m, seed=t + m)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(_jloss(jnp.asarray(h, jdt), jnp.asarray(w, jdt),
                             jnp.asarray(logq), jnp.asarray(pos), m_total))
    th, tw = torch.from_numpy(h).to(tdt), torch.from_numpy(w).to(tdt)
    got = ops.sampled_loss(th, tw, torch.from_numpy(logq),
                           torch.from_numpy(pos), m_total=m_total)
    assert got.shape == (t,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the reference's own plain version agrees as well
    jplain = jref.sampled_loss_ref(jnp.asarray(h, jdt), jnp.asarray(w, jdt),
                                   jnp.asarray(logq), jnp.asarray(pos),
                                   m_total)
    np.testing.assert_allclose(got.numpy(), np.asarray(jplain), **TOL)


def test_m_total_defaults_to_m():
    h, w, logq, pos = map(torch.from_numpy, _inputs(9, 12, 33))
    np.testing.assert_array_equal(
        ops.sampled_loss(h, w, logq, pos).numpy(),
        ops.sampled_loss(h, w, logq, pos, m_total=33).numpy())


def test_padded_negatives_carry_no_mass():
    """Negatives padded with logq = 1e30 leave the loss as it was (the
    reference's wrapper pads m to its tile this way)."""
    h, w, logq, pos = _inputs(11, 16, 20, seed=5)
    base = ops.sampled_loss(*map(torch.from_numpy, (h, w, logq, pos)),
                            m_total=20)
    wp = np.concatenate([w, np.ones((7, 16), np.float32)])
    lp = np.concatenate([logq, np.full((7,), 1e30, np.float32)])
    got = ops.sampled_loss(*map(torch.from_numpy, (h, wp, lp, pos)),
                           m_total=20)
    np.testing.assert_allclose(got.numpy(), base.numpy(), **TOL)


def test_mixed_dtypes_are_taken_as_fp32():
    h, w, logq, pos = map(torch.from_numpy, _inputs(6, 8, 10, seed=6))
    got = ops.sampled_loss(h.to(torch.bfloat16), w, logq, pos)
    want = ref.sampled_loss_ref(h.to(torch.bfloat16).float(), w, logq, pos,
                                10)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_cuda_wrapper_refuses_cpu_tensors():
    kernels.reset_launch_counts()
    h, w, logq, pos = map(torch.from_numpy, _inputs(4, 8, 6))
    with pytest.raises(ValueError, match="CUDA tensor"):
        sampled_loss(h, w, logq, pos, m_total=6)
    with pytest.raises(TypeError, match="float64"):
        sampled_loss(h.double(), w.double(), logq, pos, m_total=6)
    assert kernels.launch_counts()["sampled_loss"] == 0
