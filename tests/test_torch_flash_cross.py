"""The attention at a key length Sk apart from the query length Sq (an
encoder-decoder's cross attention: whisper's text tokens over its audio
frames), on the CPU.

* ``ops.flash_attention`` with Sk above, below and ragged against Sq
  (fp32, its plain version on the CPU) against the reference's
  ``chunked_attention``, and its gradients against ``jax.grad`` of it,
  within 1e-5 x max|ref| (fp32 summation order).
* The wrappers' shape rules: q (B, Sq, H, hd), k and v (B, Sk, KV, *),
  the output and dq like q, dk and dv like k and v, lse (B, H, Sq);
  ``s_valid`` clipped to Sk; Sk passed to both routes' entry points beside
  Sq, with k and v handed over as they are (no padding to Sq, no copy);
  a causal call with Sk != Sq refused with ``ValueError`` by the
  wrappers, ``plan`` and ``ops``.
* ``plan`` at every shape ``chip_smoke.py`` runs the tensor-core backward
  at for whisper (each (batch, query head, key tile, query step) covered
  once: key tiles over Sk, query steps over Sq), and the backward kernels'
  decomposition replayed in fp32 at Sk != Sq (the dQ kernel's two sweeps
  over Sk, the dK/dV kernel's key tiles over Sk and shares over Sq)
  against ``jax.grad``, 1e-5 x max.  The kernels themselves are held
  against the plain version on the card by ``chip_smoke.py``.
"""
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch import kernels
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

#: (b, sq, sk, h, kv, hd): keys above, below and ragged against queries,
#: groups 1, 2 and 3
OPS_SHAPES = [(2, 9, 20, 4, 2, 16), (2, 20, 9, 4, 2, 16),
              (1, 77, 300, 4, 4, 64), (1, 130, 33, 6, 2, 32)]
#: (b, sq, sk, h, kv, hd, causal) of every tensor-core backward call in
#: chip_smoke.py's whisper phases: the encoder's and the decoder's
#: self-attention, the cross attention in training, the decode check's
#: cross attention, a ragged key length below the queries, an s_valid
#: inside the keys at hd 128; and the mesh phase's shard shapes (a rank's
#: 4 clips and 5 of 20 heads at tp 4 with the cross attention's 20 whole,
#: one clip of 20 heads at pure_fsdp (2, 2))
WHISPER_CHIP_SHAPES = [(8, 1500, 1500, 20, 20, 64, False),
                       (8, 448, 448, 20, 20, 64, True),
                       (8, 448, 1500, 20, 20, 64, False),
                       (4, 33, 1500, 20, 20, 64, False),
                       (2, 300, 77, 8, 2, 64, False),
                       (2, 200, 500, 8, 2, 128, False),
                       (4, 1500, 1500, 5, 5, 64, False),
                       (4, 448, 448, 5, 5, 64, True),
                       (4, 448, 1500, 20, 20, 64, False),
                       (1, 1500, 1500, 20, 20, 64, False),
                       (1, 448, 448, 20, 20, 64, True),
                       (1, 448, 1500, 20, 20, 64, False)]
TOL = 1e-5


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _inputs(seed, b, sq, sk, h, kv, hd):
    return [_normal(seed + i, shape) for i, shape in enumerate(
        [(b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd), (b, sq, h, hd)])]


def _close(got, want, tol=TOL, msg=""):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, msg
    bound = tol * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{msg}: {err} > {bound}"


_jforward = jax.jit(lambda q, k, v: JL.chunked_attention(
    q, k, v, causal=False, chunk=64))


@functools.lru_cache(maxsize=None)
def _jgrad():
    def loss(q, k, v, do):
        return jnp.sum(JL.chunked_attention(q, k, v, causal=False,
                                            chunk=64) * do)
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))


@pytest.mark.parametrize("b,sq,sk,h,kv,hd", OPS_SHAPES)
def test_ops_forward_and_gradients_match_jax(b, sq, sk, h, kv, hd):
    q, k, v, do = _inputs(3, b, sq, sk, h, kv, hd)
    want = _jforward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=False)
    assert out.shape == (b, sq, h, hd)
    _close(out.detach().numpy(), want, msg="out")
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    jgrads = _jgrad()(*(jnp.asarray(x) for x in (q, k, v, do)))
    for name, g, w in zip("qkv", got, jgrads):
        assert g.shape == (tq, tk, tv)["qkv".index(name)].shape
        _close(g.numpy(), w, msg=f"d{name}")


def test_ops_refuses_a_causal_call_with_another_key_length():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 1, 8, 12, 2, 2,
                                                          16))
    with pytest.raises(ValueError, match="causal"):
        ops.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="causal"):
        fa.plan(1, 8, 2, 2, 16, True, sk=12)


def _recording(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "check", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=5))
    monkeypatch.setattr(fa, "_sms", lambda index: fa.H100_SMS)
    kernels.reset_launch_counts()
    return calls


@pytest.mark.parametrize("dtype,entry", [
    (torch.bfloat16, "flash_attention"),
    (torch.float32, "flash_attention_simt")])
def test_forward_takes_the_key_length_on_both_routes(dtype, entry,
                                                     monkeypatch):
    """q (2, 40, 8, 64) over k, v (2, 100, 2, 64): the entry gets (B, Sq,
    Sk, H, KV, hd, hv, s_valid, causal, scale) with k's and v's own
    pointers (nothing padded or copied); s_valid defaults to Sk and clips
    to it; the output is (B, Sq, H, hv), the lse (B, H, Sq)."""
    calls = _recording(monkeypatch)
    q = torch.zeros((2, 40, 8, 64), dtype=dtype)
    k = torch.zeros((2, 100, 2, 64), dtype=dtype)
    v = torch.zeros((2, 100, 2, 64), dtype=dtype)
    scale = 1.0 / math.sqrt(64)
    tail = (None, 5) if entry == "flash_attention" else (
        int(dtype == torch.bfloat16), None, 5)
    for s_valid, want_sv in ((None, 100), (150, 100), (70, 70)):
        out = fa.flash_attention(q, k, v, causal=False, s_valid=s_valid)
        assert out.shape == (2, 40, 8, 64)
        assert calls[-1][0] == entry
        assert calls[-1][1:3] == (q.data_ptr(), k.data_ptr())
        assert calls[-1][3] == v.data_ptr()
        assert calls[-1][5:] == (2, 40, 100, 8, 2, 64, 64, want_sv, 0,
                                 scale) + tail
    out, lse = fa.flash_attention(q, k, v, causal=False, with_lse=True)
    assert lse.shape == (2, 8, 40) and calls[-1][0] == entry + "_lse"
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="shape mismatch"):
        fa.flash_attention(q, k, v[:, :99], causal=False)
    with pytest.raises(ValueError, match="shape mismatch"):
        fa.flash_attention(q, k[:1], v[:1], causal=False)
    assert kernels.launch_counts()[entry] == 4


@pytest.mark.parametrize("dtype,entry", [
    (torch.bfloat16, "flash_attention_bwd"),
    (torch.float32, "flash_attention_bwd_simt")])
def test_backward_takes_the_key_length_on_both_routes(dtype, entry,
                                                      monkeypatch):
    """dq like q (B, Sq, ...), dk and dv like k and v (B, Sk, ...); the
    entry gets Sq and Sk; the tensor-core route's plan is the one at Sk,
    its counters b * KV * ceil(Sk / key tile); dout and lse are held to
    Sq."""
    calls = _recording(monkeypatch)
    seen = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: seen.append(
        (a, kw.get("dtype"))) or real_empty(*a, **kw))
    b, sq, sk, h, kv, hd = 2, 448, 1500, 4, 4, 64
    q, do = (torch.zeros((b, sq, h, hd), dtype=dtype) for _ in range(2))
    k, v = (torch.zeros((b, sk, kv, hd), dtype=dtype) for _ in range(2))
    lse = torch.zeros((b, h, sq))
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, do, lse, causal=False)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert calls[-1][0] == entry
    n_ptr = 11 if entry == "flash_attention_bwd" else 9
    assert calls[-1][n_ptr + 1:n_ptr + 11] == (
        b, sq, sk, h, kv, hd, hd, sk, 0, 1.0 / math.sqrt(hd))
    if entry == "flash_attention_bwd":
        p = fa.plan(b, sq, h, kv, hd, False, sk=sk)
        assert calls[-1][n_ptr + 11] == p.chunk
        assert p.counters == b * kv * -(-sk // fa.KEY_TILE)
        assert ((p.counters,), torch.int32) in seen
    assert ((b, h, sq),) in [a for a, _ in seen]  # D, at Sq
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_bwd(q, k, v, torch.zeros((b, sk, h, hd),
                                                    dtype=dtype), lse,
                               causal=False)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, do, torch.zeros((b, h, sk)),
                               causal=False)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention_bwd(q, k, v, do, lse)
    assert kernels.launch_counts()[entry] == 1


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal", WHISPER_CHIP_SHAPES)
def test_plan_covers_every_step_once_at_whisper_shapes(b, sq, sk, h, kv, hd,
                                                       causal):
    """Key tiles run over Sk and each tile's (query head, query step)
    steps over Sq: every (batch, query head, key tile, query step) the
    mask keeps is one block's, once."""
    p = fa.plan(b, sq, h, kv, hd, causal, sk=sk)
    group, n_qt = h // kv, -(-sq // fa.QUERY_STEP)
    n_kt = -(-sk // p.key_tile)
    assert len(p.steps) == len(p.splits) == n_kt
    assert p.counters == b * kv * n_kt
    assert p.dq_blocks == b * h * -(-sq // fa.DQ_QUERY_TILE)
    seen = set()
    blocks = 0
    for kt in range(n_kt):
        qt_first = kt * p.key_tile // fa.QUERY_STEP if causal else 0
        per_head = n_qt - qt_first
        assert p.steps[kt] == group * per_head
        for bkv in range(b * kv):
            for t0, t1 in p.shares(kt):
                assert 1 <= t1 - t0 <= p.chunk
                blocks += 1
                for t in range(t0, t1):
                    cell = (bkv // kv, (bkv % kv) * group + t // per_head,
                            kt, qt_first + t % per_head)
                    assert cell not in seen
                    seen.add(cell)
    assert blocks == p.blocks
    want = {(bb, hh, kt, qt) for bb in range(b) for hh in range(h)
            for kt in range(n_kt) for qt in range(n_qt)
            if not causal or qt >= kt * p.key_tile // fa.QUERY_STEP}
    assert seen == want


def test_plan_at_the_cross_attention_training_shape():
    """(8, 448 / 1,500, 20 / 20, 64): a group of one, so a key tile of 128
    keys has 7 query steps of 64; 8 x 20 x 12 = 1,920 key tiles, 15 waves
    over 132 SMs, none split."""
    p = fa.plan(8, 448, 20, 20, 64, False, sk=1500)
    assert p.steps == (7,) * 12 and max(p.splits) == 1
    assert p.blocks == 1920 and p.waves == 15 and p.workspace_floats == 0


def _replay(q, k, v, dout, s_valid=None):
    """The tensor-core backward's decomposition in fp32, not causal, at
    Sk != Sq: the dQ kernel's blocks of 128 queries (two warpgroups of 64)
    sweeping Sk's 64-key tiles twice (D, then dS and dQ), and the dK/dV
    kernel's blocks of 128 of Sk's keys sweeping their share of (query
    head, 64-query step)s over Sq, folded in share order."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    group = h // kv
    scale = 1.0 / math.sqrt(hd)
    kv_lim = sk if s_valid is None else min(sk, s_valid)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    _, lse = ref.flash_attention_ref(q, k, v, causal=False, s_valid=s_valid,
                                     with_lse=True)

    def probs(bb, hh, qs, ks):
        sc = qf[bb, qs, hh] @ kf[bb, ks, hh // group].T * scale
        p = torch.exp(sc - lse[bb, hh, qs][:, None])
        return torch.where(ks[None, :] < kv_lim, p, 0.0)

    dq = torch.zeros_like(qf)
    delta = torch.zeros(b, h, sq)
    tiles = [torch.arange(k0, min(k0 + 64, sk)) for k0 in range(0, kv_lim,
                                                                  64)]
    for bb in range(b):
        for hh in range(h):
            for w0 in range(0, sq, 64):
                qs = torch.arange(w0, min(w0 + 64, sq))
                d = torch.zeros(len(qs))
                for ks in tiles:  # first sweep: D
                    dp = dof[bb, qs, hh] @ vf[bb, ks, hh // group].T
                    d += (probs(bb, hh, qs, ks) * dp).sum(1)
                delta[bb, hh, qs] = d
                acc = torch.zeros(len(qs), hd)
                for ks in tiles:  # second sweep: dQ
                    dp = dof[bb, qs, hh] @ vf[bb, ks, hh // group].T
                    acc += (probs(bb, hh, qs, ks) * (dp - d[:, None])) @ \
                        kf[bb, ks, hh // group]
                dq[bb, qs, hh] = acc * scale
    p = fa.plan(b, sq, h, kv, hd, False, sk=sk)
    n_qt = -(-sq // fa.QUERY_STEP)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for kt in range(len(p.steps)):
        ks = torch.arange(kt * p.key_tile, min((kt + 1) * p.key_tile, sk))
        for bkv in range(b * kv):
            bb, kvh = bkv // kv, bkv % kv
            fk, fv = torch.zeros(len(ks), hd), torch.zeros(len(ks), hd)
            for t0, t1 in p.shares(kt):  # share order
                pk, pv = torch.zeros(len(ks), hd), torch.zeros(len(ks), hd)
                for t in range(t0, t1):
                    hh = kvh * group + t // n_qt
                    q0 = (t % n_qt) * fa.QUERY_STEP
                    qs = torch.arange(q0, min(q0 + fa.QUERY_STEP, sq))
                    pt = probs(bb, hh, qs, ks).T
                    dpt = vf[bb, ks, kvh] @ dof[bb, qs, hh].T
                    pv += pt @ dof[bb, qs, hh]
                    pk += (pt * (dpt - delta[bb, hh, qs][None, :])) @ \
                        qf[bb, qs, hh]
                fk += pk
                fv += pv
            dk[bb, ks, kvh] = fk * scale
            dv[bb, ks, kvh] = fv
    return dq, dk, dv


@pytest.mark.parametrize("b,sq,sk,h,kv,hd", [
    (1, 150, 300, 2, 2, 16),   # keys above queries, ragged, MHA
    (2, 200, 77, 6, 2, 16),    # keys below queries, group 3, split tiles
])
def test_replay_at_a_key_length_matches_jax_grad(b, sq, sk, h, kv, hd):
    q, k, v, do = _inputs(20, b, sq, sk, h, kv, hd)
    want = _jgrad()(*(jnp.asarray(x) for x in (q, k, v, do)))
    got = _replay(*(torch.from_numpy(x) for x in (q, k, v, do)))
    for name, g, w in zip("qkv", got, want):
        _close(g.numpy(), w, msg=f"d{name}")


def test_replay_with_s_valid_inside_the_keys():
    """Keys at or past s_valid carry no mass and get no gradient: the
    replay against autograd through the plain version."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(30, 1, 90, 200, 4,
                                                         2, 16))
    got = _replay(q, k, v, do, s_valid=130)
    want = ref.flash_attention_bwd_ref(q, k, v, do, causal=False,
                                       s_valid=130)
    for name, g, w in zip("qkv", got, want):
        _close(g.numpy(), w.numpy(), msg=f"d{name}")
    assert float(got[1][:, 130:].abs().max()) == 0.0
