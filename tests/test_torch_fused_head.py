"""The port's fused sampled-softmax head (``repro_torch.kernels.ops
.fused_head_lse``) against the JAX package's, on the CPU.

Both sides get the same numpy inputs: the port runs its plain chunked path
(the CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against this path), the reference its chunked path, and one small case its
Pallas kernel in interpret mode.  Inputs carry masked slots (``MASK_CORR``)
and ids repeated within and across tokens.  Tolerances: forward rtol 1e-5
and gradients rtol 1e-5 / atol 1e-6 (fp32 sums of d-term products in
other orders).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampled_softmax as jss
from repro.kernels import ops as jops
from repro_torch import kernels
from repro_torch.core import sampled_softmax as ss
from repro_torch.kernels import fused_head, ops, ref

torch.set_num_threads(1)

N_ROWS = 64


def _inputs(t, k, d, seed=0):
    """w (64, d), h (t, d), ids / corr / biasg (t, k): ids repeat within a
    token (last slot = first) and across tokens (token 1's slot 1 = token
    0's label); the middle token's last slot is masked."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(N_ROWS, d)) * 0.4).astype(np.float32)
    h = (rng.normal(size=(t, d)) * 0.4).astype(np.float32)
    ids = rng.integers(0, N_ROWS // 2, (t, k)).astype(np.int32)
    if k > 1:
        ids[:, -1] = ids[:, 0]
        if t > 1:
            ids[1, 1] = ids[0, 0]
    corr = (rng.normal(size=(t, k)) * 0.5).astype(np.float32)
    corr[:, 0] = 0.0
    if k > 1:
        corr[t // 2, -1] = ops.MASK_CORR
    biasg = (rng.normal(size=(t, k)) * 0.2).astype(np.float32)
    return w, h, ids, corr, biasg


def _jax_lse_and_grads(w, h, ids, corr, biasg, abs_mode, impl):
    @jax.jit
    def run(w, h, ids, corr, biasg):
        def loss(w_, h_, c_, b_):
            lse = jops.fused_head_lse(w_, h_, ids, c_, b_, abs_mode=abs_mode,
                                      impl=impl)
            return jnp.sum(jnp.cos(lse)), lse
        (_, lse), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True)(w, h, corr, biasg)
        return lse, grads

    lse, grads = run(w, h, ids, corr, biasg)
    return np.asarray(lse), [np.asarray(g) for g in grads]


def _torch_lse_and_grads(w, h, ids, corr, biasg, abs_mode, impl="auto"):
    ts = [torch.from_numpy(x).requires_grad_() for x in (w, h, corr, biasg)]
    lse = ops.fused_head_lse(ts[0], ts[1], torch.from_numpy(ids).long(),
                             ts[2], ts[3], abs_mode=abs_mode, impl=impl)
    torch.sum(torch.cos(lse)).backward()
    return lse.detach().numpy(), [x.grad.numpy() for x in ts]


@pytest.mark.parametrize("abs_mode", [False, True])
@pytest.mark.parametrize("d", [8, 32])
@pytest.mark.parametrize("m", [1, 7, 16])
@pytest.mark.parametrize("t", [1, 5, 37])
def test_fused_head_matches_reference_chunked(t, m, d, abs_mode):
    """Forward and dL/d(w, h, corr, biasg) of a sum(cos(lse)) loss (so the
    upstream cotangent differs per token) against ``jax.grad`` of the
    reference's chunked path."""
    args = _inputs(t, 1 + m, d, seed=t * 100 + m * 10 + d)
    want, wgrads = _jax_lse_and_grads(*args, abs_mode, "chunked")
    got, grads = _torch_lse_and_grads(*args, abs_mode)
    assert got.shape == (t,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for g, r, name in zip(grads, wgrads, ["dw", "dh", "dcorr", "dbiasg"]):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("abs_mode", [False, True])
def test_fused_head_matches_reference_pallas_interpret(abs_mode):
    """The reference's Pallas kernels (interpret mode on the CPU)."""
    args = _inputs(5, 9, 16, seed=7)
    want, wgrads = _jax_lse_and_grads(*args, abs_mode, "pallas")
    got, grads = _torch_lse_and_grads(*args, abs_mode)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for g, r, name in zip(grads, wgrads, ["dw", "dh", "dcorr", "dbiasg"]):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_masked_slot_has_zero_mass_and_gradient():
    """A MASK_CORR slot changes nothing: the same lse as without the slot,
    and zero dcorr / dbiasg there."""
    w, h, ids, corr, biasg = _inputs(4, 6, 8, seed=3)
    corr[:, 3] = ops.MASK_CORR
    got, grads = _torch_lse_and_grads(w, h, ids, corr, biasg, True)
    keep = [0, 1, 2, 4, 5]
    want = ref.fused_lse_ref(*(torch.from_numpy(x) for x in (
        w, h, ids[:, keep], corr[:, keep], biasg[:, keep])), True)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6)
    assert not grads[2][:, 3].any() and not grads[3][:, 3].any()


@pytest.mark.parametrize("impl", ["auto", "fused", "pallas", "chunked"])
def test_impl_names_take_the_plain_path_on_cpu(impl):
    """Every kept impl name runs the plain path for CPU tensors and
    launches nothing."""
    kernels.reset_launch_counts()
    args = _inputs(3, 4, 8)
    got, _ = _torch_lse_and_grads(*args, False, impl=impl)
    want = ref.fused_lse_ref(*(torch.from_numpy(x) for x in args), False)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6)
    assert not any(kernels.launch_counts().values())


def test_unknown_impl_raises():
    args = [torch.from_numpy(x) for x in _inputs(2, 3, 8)]
    with pytest.raises(ValueError, match="impl"):
        ops.fused_head_lse(*args, impl="einsum")


@pytest.mark.parametrize("call", [
    lambda a: fused_head.fused_lse(*a),
    lambda a: fused_head.fused_lse_bwd(*a, torch.zeros(2), torch.ones(2)),
], ids=["fused_lse", "fused_lse_bwd"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """The kernel wrappers launch or raise; a CPU tensor is refused before
    anything is built, and no launch is counted."""
    kernels.reset_launch_counts()
    w, h, ids, corr, biasg = (torch.from_numpy(x)
                              for x in _inputs(2, 3, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        call((w, h, ids, corr, biasg))
    assert not any(kernels.launch_counts().values())


def test_bf16_head_on_the_card_launches_with_the_bf16_flag(monkeypatch):
    """A bf16 head and bf16 hidden states reach both kernels as they are,
    with the bf16 flag set (the device check and the launches are stood
    in for: nothing is computed), the gradients come back in bf16, and
    each entry counts one launch."""
    calls = []
    monkeypatch.setattr(ops, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(fused_head._build, "check", lambda *a, **k: None)
    monkeypatch.setattr(fused_head._build, "launch",
                        lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=7))
    kernels.reset_launch_counts()
    w, h, ids, corr, biasg = (torch.from_numpy(x) for x in _inputs(2, 3, 8))
    wb = w.bfloat16().requires_grad_()
    hb = h.bfloat16().requires_grad_()
    lse = ops.fused_head_lse(wb, hb, ids, corr, biasg, abs_mode=True)
    lse.sum().backward()
    assert [c[0] for c in calls] == ["fused_lse", "fused_lse_bwd"]
    fwd, bwd = calls[0][1], calls[1][1]
    assert fwd[6:10] == (2, 3, 8, 1) and fwd[10] == 1  # T, K, d, abs; bf16
    assert bwd[12:18] == (2, 3, 8, N_ROWS, 1, 1)  # T, K, d, n, abs, bf16
    assert wb.grad.dtype == hb.grad.dtype == torch.bfloat16
    assert kernels.launch_counts()["fused_lse"] == 1
    assert kernels.launch_counts()["fused_lse_bwd"] == 1


@pytest.mark.parametrize("abs_mode", [False, True])
def test_bf16_inputs_match_the_reference(abs_mode):
    """bf16 w and h through ``ops.fused_head_lse`` (the plain path here, the
    kernels' plain version on the card) against the reference on the same
    bf16 values: lse and the fp32 corr / biasg cotangents within rtol
    1e-5; dL/dw and dL/dh, returned in bf16 by both, within one bf16 ulp
    (their fp32 sums round to bf16 apart where they straddle a step)."""
    w, h, ids, corr, biasg = _inputs(9, 8, 16, seed=21)
    wb = torch.from_numpy(w).bfloat16()
    hb = torch.from_numpy(h).bfloat16()

    @jax.jit
    def run(w_, h_, c_, b_):
        def loss(w_, h_, c_, b_):
            lse = jops.fused_head_lse(w_, h_, ids, c_, b_,
                                      abs_mode=abs_mode, impl="chunked")
            return jnp.sum(jnp.cos(lse)), lse
        return jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                  has_aux=True)(w_, h_, c_, b_)

    (_, want), wgrads = run(jnp.asarray(wb.float().numpy(), jnp.bfloat16),
                            jnp.asarray(hb.float().numpy(), jnp.bfloat16),
                            corr, biasg)
    ts = [wb.requires_grad_(), hb.requires_grad_()] + [
        torch.from_numpy(x).requires_grad_() for x in (corr, biasg)]
    lse = ops.fused_head_lse(ts[0], ts[1], torch.from_numpy(ids).long(),
                             ts[2], ts[3], abs_mode=abs_mode)
    torch.sum(torch.cos(lse)).backward()
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(want),
                               rtol=1e-5)
    for x, g, name in zip(ts, wgrads, ["dw", "dh", "dcorr", "dbiasg"]):
        got = x.grad.float().numpy()
        ref_g = np.asarray(g.astype(jnp.float32))
        if name in ("dw", "dh"):
            assert x.grad.dtype == torch.bfloat16
            np.testing.assert_allclose(got, ref_g, rtol=2**-8, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got, ref_g, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("abs_mode", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_from_embeddings_fused_matches_einsum_and_reference(with_bias,
                                                            abs_mode):
    """``sampled_softmax_from_embeddings``: the fused dispatch equals the
    port's einsum path and the reference's (loss and dL/dw, dL/dh), with
    forced accidental hits."""
    rng = np.random.default_rng(11)
    n, d, t, m = 48, 12, 9, 14
    w = (rng.normal(size=(n, d)) * 0.5).astype(np.float32)
    h = (rng.normal(size=(t, d)) * 0.5).astype(np.float32)
    labels = rng.integers(0, n, (t,)).astype(np.int32)
    neg = rng.integers(0, n, (t, m)).astype(np.int32)
    neg[:3, 2] = labels[:3]  # accidental hits
    logq = np.log(rng.dirichlet(np.ones(n), size=t)[
        np.arange(t)[:, None], neg]).astype(np.float32)
    bias = (rng.normal(size=(n,)) * 0.3).astype(np.float32) \
        if with_bias else None

    def jloss(w_, h_):
        return jnp.sum(jss.sampled_softmax_from_embeddings(
            w_, h_, labels, neg, logq, abs_mode=abs_mode,
            bias=None if bias is None else jnp.asarray(bias),
            impl="chunked"))
    jl, (jdw, jdh) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        w, h)
    for impl in ("fused", "einsum"):
        tw, th = (torch.from_numpy(x).requires_grad_() for x in (w, h))
        loss = torch.sum(ss.sampled_softmax_from_embeddings(
            tw, th, torch.from_numpy(labels).long(),
            torch.from_numpy(neg).long(), torch.from_numpy(logq),
            abs_mode=abs_mode,
            bias=None if bias is None else torch.from_numpy(bias),
            impl=impl))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                                   rtol=1e-5, atol=1e-6, err_msg=impl)
        np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh),
                                   rtol=1e-5, atol=1e-6, err_msg=impl)
