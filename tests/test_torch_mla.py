"""Multi-head Latent Attention in the port (``repro_torch.models.mla``) and
the attention kernels' value width, against the JAX package, on
``get_config("deepseek-v3-671b").reduced()`` (fp32, d 64, 4 heads, q/k
width 24 = nope 16 + rope 8, value width 16, q_lora 32, kv_lora 32).

* ``init_mla``'s tree against the reference's (keys, shapes, dtypes), and
  ``_queries``, ``_latent``, ``mla_forward`` (with its gradients),
  ``mla_latent_cache`` and ``mla_decode`` (its output and the cache it
  writes in place) on the reference's weights: within 1e-5 x max|ref|
  (both sides compute in fp32 and differ only in summation order).
* ``ops.flash_attention`` and ``ref.flash_attention_bwd_ref`` at hv != hd
  against the reference's ``chunked_attention`` and ``jax.grad`` of it:
  1e-5 (rtol and atol).
* The CUDA wrappers' shape checks and route choice at MLA's (192, 128)
  and around it, and their arguments (the launch is replaced by a
  recorder: no card here).
* ``flash_attention.plan`` at every MLA shape ``chip_smoke.py`` runs the
  tensor-core backward at: every (query head, query tile, key tile) step
  once, the fold's slots, the workspace of the wide tile's roles.

The JAX side runs under ``jax.jit``.
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

from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro.models import mla as JMLA
from repro.sharding.rules import local_ctx
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import mla

torch.set_num_threads(1)

CTX = local_ctx()
JCFG = jget_config("deepseek-v3-671b").reduced()
CFG = get_config("deepseek-v3-671b").reduced()
B, S = 2, 11
TOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL, msg=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, msg
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{msg}: max |got - want| {err} > {bound}"


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's init_mla, its norm scales moved off 1."""
    jp = _np_tree(jax.jit(lambda k: JMLA.init_mla(k, JCFG))(
        jax.random.PRNGKey(0)))
    for i, name in enumerate(("q_a_norm", "kv_a_norm")):
        n = jp[name]["scale"].shape
        jp[name]["scale"] = 1.0 + _normal(10 + i, n, 0.1)
    return jp


def _jp():
    return jax.tree_util.tree_map(jnp.asarray, _weights())


def _tp():
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                  _weights())


def _x(seed=1, s=S):
    return _normal(seed, (B, s, CFG.d_model))


def _positions(s=S):
    return np.broadcast_to(np.arange(s)[None, :], (B, s)).astype(np.int32)


def test_config_matches_reference():
    from dataclasses import asdict
    assert asdict(get_config("deepseek-v3-671b")) == asdict(
        jget_config("deepseek-v3-671b"))
    assert asdict(CFG) == asdict(JCFG)
    assert (CFG.qk_nope_dim + CFG.qk_rope_dim, CFG.v_head_dim) == (24, 16)


def test_init_mla_tree_matches_reference():
    want = jax.eval_shape(lambda k: JMLA.init_mla(k, JCFG),
                          jax.random.PRNGKey(0))
    got = mla.init_mla(torch.Generator().manual_seed(0), CFG,
                       torch.device("cpu"))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path


def test_queries_and_latent_match_reference():
    x, pos = _x(), _positions()
    jq = jax.jit(lambda p, x, pos: JMLA._queries(p, x, pos, JCFG,
                                                 jnp.float32))(
        _jp(), x, pos)
    jl = jax.jit(lambda p, x, pos: JMLA._latent(p, x, pos, JCFG,
                                                jnp.float32))(
        _jp(), x, pos)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos).long()
    q = mla._queries(_tp(), tx, tpos, CFG, torch.float32)
    lat = mla._latent(_tp(), tx, tpos, CFG, torch.float32)
    for name, g, w in zip(("q_nope", "q_rope", "c_kv", "k_rope"),
                          (*q, *lat), (*jq, *jl)):
        _close(g.numpy(), w, msg=name)
    cache = mla.mla_latent_cache(_tp(), tx, tpos, CFG)
    jcache = jax.jit(lambda p, x, pos: JMLA.mla_latent_cache(
        p, x, pos, JCFG))(_jp(), x, pos)
    assert cache.shape == (B, S, CFG.kv_lora_rank + CFG.qk_rope_dim)
    _close(cache.numpy(), jcache, msg="latent cache")


@pytest.mark.parametrize("causal", [True, False])
def test_mla_forward_and_its_gradients_match_reference(causal):
    """The expanded form (q/k width 24, value width 16) through
    ``ops.flash_attention``'s plain version, and the gradients of sum(y *
    r) in x and every weight against ``jax.grad``."""
    x, pos = _x(2), _positions()
    r = _normal(3, (B, S, CFG.d_model))

    def jloss(p, x):
        y = JMLA.mla_forward(p, x, pos, JCFG, CTX, causal=causal)
        return jnp.sum(y * r), y
    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True))(_jp(), x)
    tp = {k: (v.requires_grad_(True) if isinstance(v, torch.Tensor)
              else {kk: vv.requires_grad_(True) for kk, vv in v.items()})
          for k, v in _tp().items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y = mla.mla_forward(tp, tx, torch.from_numpy(pos).long(), CFG,
                        causal=causal)
    _close(y.detach().numpy(), jy, msg="y")
    leaves = jax.tree_util.tree_leaves(tp) + [tx]
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(r)), leaves)
    want = jax.tree_util.tree_leaves(jg[0]) + [jg[1]]
    for g, w in zip(grads, want):
        _close(g.numpy(), w, msg="grad")


def test_mla_decode_writes_the_cache_and_matches_reference():
    """Two absorbed-form decode steps after a 7-token latent prefill at
    positions that differ per row: y and the cache (written in place)
    against the reference's; and y against the expanded forward at that
    position."""
    s_max = 10
    x = _x(4, s_max)
    pos_all = _positions(s_max)
    tp = _tp()
    full = mla.mla_forward(tp, torch.from_numpy(x),
                           torch.from_numpy(pos_all).long(), CFG)
    cache = torch.zeros((B, s_max, CFG.kv_lora_rank + CFG.qk_rope_dim))
    cache[:, :7] = mla.mla_latent_cache(
        tp, torch.from_numpy(x[:, :7]), torch.from_numpy(pos_all[:, :7]
                                                         ).long(), CFG)
    jcache = jnp.asarray(cache.numpy())
    jdec = jax.jit(lambda p, x, c, pos: JMLA.mla_decode(p, x, c, pos, JCFG,
                                                        CTX))
    for t in (7, 8):
        pos = np.full((B,), t, np.int32)
        jy, jcache = jdec(_jp(), x[:, t:t + 1], jcache, pos)
        before = cache
        y, out = mla.mla_decode(tp, torch.from_numpy(x[:, t:t + 1]), cache,
                                torch.from_numpy(pos).long(), CFG)
        assert out is before  # in place
        _close(y.numpy(), jy, msg=f"y at {t}")
        _close(cache.numpy(), jcache, msg=f"cache at {t}")
        _close(y[:, 0].numpy(), full[:, t].numpy(), 1e-4, "decode vs fwd")
    # ragged positions: one row a step behind the other
    pos = np.array([5, 8], np.int32)
    jy, _ = jdec(_jp(), x[:, 9:10], jcache, pos)
    y, _ = mla.mla_decode(tp, torch.from_numpy(x[:, 9:10]), cache,
                          torch.from_numpy(pos).long(), CFG)
    _close(y.numpy(), jy, msg="ragged positions")


# --- the kernels' value width ------------------------------------------------

@functools.partial(jax.jit, static_argnames=("causal",))
def _jchunked(q, k, v, causal):
    return JL.chunked_attention(q, k, v, causal=causal, chunk=32)


@functools.partial(jax.jit, static_argnames=("causal",))
def _jchunked_grad(q, k, v, dout, causal):
    return jax.grad(lambda q, k, v: jnp.sum(
        JL.chunked_attention(q, k, v, causal=causal, chunk=32) * dout),
        argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("h,kv,hd,hv", [(4, 4, 24, 16), (8, 2, 24, 16),
                                        (4, 4, 192, 128), (4, 2, 32, 48)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_at_hv_ne_hd_matches_chunked_attention(
        h, kv, hd, hv, causal):
    """``ops.flash_attention`` (its plain version on CPU tensors; the
    kernels' function) and ``flash_attention_bwd_ref`` at a value width
    apart from the q/k width, ragged S 45, against the reference's
    ``chunked_attention`` and ``jax.grad`` of it; autograd through
    ``ops.flash_attention`` gives the backward's plain version."""
    rng = np.random.default_rng(hd + hv + h)
    s = 45
    q = rng.normal(size=(1, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(1, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(1, s, kv, hv)).astype(np.float32)
    dout = rng.normal(size=(1, s, h, hv)).astype(np.float32)
    want = np.asarray(_jchunked(q, k, v, causal))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (1, s, h, hv)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL)
    jgrads = _jchunked_grad(q, k, v, dout, causal)
    bwd = ref.flash_attention_bwd_ref(tq, tk, tv, torch.from_numpy(dout),
                                      causal=causal)
    auto = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(dout))
    for name, g, a, w in zip("qkv", bwd, auto, jgrads):
        assert g.shape == a.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=name)
        np.testing.assert_allclose(a.numpy(), g.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=name)


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


@pytest.mark.parametrize("dtype,hd,hv,entry", [
    (torch.bfloat16, 192, 128, "flash_attention"),
    (torch.bfloat16, 160, 96, "flash_attention"),
    (torch.bfloat16, 64, 32, "flash_attention"),
    (torch.bfloat16, 32, 128, "flash_attention"),
    (torch.bfloat16, 192, 144, "flash_attention_simt"),
    (torch.bfloat16, 208, 128, "flash_attention_simt"),
    (torch.bfloat16, 24, 16, "flash_attention_simt"),
    (torch.bfloat16, 192, 120, "flash_attention_simt"),
    (torch.float32, 192, 128, "flash_attention_simt"),
    (torch.float32, 256, 256, "flash_attention_simt"),
])
def test_forward_route_and_arguments_at_a_value_width(dtype, hd, hv, entry,
                                                      monkeypatch):
    """bf16 with hd and hv multiples of 16, hd <= 192 and hv <= 128 takes
    the tensor-core entry (MLA's (192, 128) among them); anything else the
    CUDA-core one.  Both get (B, Sq, Sk, H, KV, hd, hv, s_valid, causal,
    scale) and write a (B, S, H, hv) output."""
    calls = _recording(monkeypatch)
    q = torch.zeros((2, 40, 8, hd), dtype=dtype)
    k = torch.zeros((2, 40, 2, hd), dtype=dtype)
    v = torch.zeros((2, 40, 2, hv), dtype=dtype)
    out = fa.flash_attention(q, k, v, causal=True, s_valid=33)
    assert out.shape == (2, 40, 8, hv) and out.dtype == dtype
    assert [c[0] for c in calls] == [entry]
    want = (2, 40, 40, 8, 2, hd, hv, 33, 1, 1.0 / math.sqrt(hd))
    want += (None, 5) if entry == "flash_attention" else (
        int(dtype == torch.bfloat16), None, 5)
    assert calls[0][5:] == want
    assert fa.uses_tensor_cores(q, k, v) == (entry == "flash_attention")
    out, lse = fa.flash_attention(q, k, v, with_lse=True)
    assert lse.shape == (2, 8, 40) and lse.dtype == torch.float32
    assert calls[-1][0] == entry + "_lse"


def test_wrappers_refuse_shapes_they_do_not_take(monkeypatch):
    _recording(monkeypatch)
    bf = torch.bfloat16
    q = torch.zeros((1, 8, 4, 192), dtype=bf)
    k = torch.zeros((1, 8, 4, 192), dtype=bf)
    with pytest.raises(ValueError, match="value head dim"):
        fa.flash_attention(q, k, torch.zeros((1, 8, 4, 272), dtype=bf))
    with pytest.raises(ValueError, match="shape mismatch"):
        fa.flash_attention(q, k, torch.zeros((1, 7, 4, 128), dtype=bf))
    with pytest.raises(ValueError, match="shape mismatch"):
        fa.flash_attention(q, k[..., :128], torch.zeros((1, 8, 4, 128),
                                                        dtype=bf))
    v = torch.zeros((1, 8, 4, 128), dtype=bf)
    lse = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_bwd(q, k, v, torch.zeros_like(q), lse)
    assert kernels.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("b,s", [(4, 512), (1, 511)])
def test_backward_route_plan_and_arguments_at_mla_widths(b, s, monkeypatch):
    """bf16 (192, 128) takes the tensor-core backward with the plan's
    chunk and a workspace of its size; dq and dk are (…, 192), dv (…,
    128); fp32 at the same widths the CUDA-core backward."""
    calls = _recording(monkeypatch)
    seen = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: seen.append(
        (a, kw.get("dtype"))) or real_empty(*a, **kw))
    h = 8  # the plan's arithmetic does not depend on H = KV beyond B * KV
    for dtype, entry in ((torch.bfloat16, "flash_attention_bwd"),
                         (torch.float32, "flash_attention_bwd_simt")):
        q = torch.zeros((b, s, h, 192), dtype=dtype)
        k = torch.zeros((b, s, h, 192), dtype=dtype)
        v = torch.zeros((b, s, h, 128), dtype=dtype)
        do = torch.zeros((b, s, h, 128), dtype=dtype)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, do,
                                            torch.zeros((b, h, s)))
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
        assert calls[-1][0] == entry
        ints = calls[-1][12:22] if entry == "flash_attention_bwd" else \
            calls[-1][10:20]
        assert ints == (b, s, s, h, h, 192, 128, s, 1, 1.0 / math.sqrt(192))
    p = fa.plan(b, s, h, h, 192, True, hv=128)
    assert p.key_tile == fa.WIDE_KEY_TILE
    assert calls[0][22:] == (p.chunk, None, 5)
    assert ((p.workspace_floats,), torch.float32) in seen
    assert ((p.counters,), torch.int32) in seen
    counts = kernels.launch_counts()
    assert counts["flash_attention_bwd"] == counts[
        "flash_attention_bwd_simt"] == 1


def test_build_signatures_carry_the_value_width():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    assert _build.SIGNATURES["flash_attention_lse"][2] == (
        (p,) * 5 + (i,) * 9 + (f, i, p))
    assert _build.SIGNATURES["flash_attention_simt_lse"][2] == (
        (p,) * 5 + (i,) * 9 + (f, i, i, p))


#: every shape chip_smoke.py runs the tensor-core backward at with a value
#: width: MLA's serving, training and mtp shapes (H = KV 128, hd 192, hv
#: 128, causal), then its off-path cases
MLA_CHIP_SHAPES = [
    (4, 512, 128, 128, 192, 128, True), (1, 512, 128, 128, 192, 128, True),
    (1, 511, 128, 128, 192, 128, True), (2, 200, 8, 2, 192, 128, True),
    (1, 300, 8, 8, 192, 128, False), (1, 200, 4, 2, 160, 96, True),
    (1, 200, 4, 2, 64, 32, True)]


@pytest.mark.parametrize("b,s,h,kv,hd,hv,causal", MLA_CHIP_SHAPES)
def test_plan_covers_every_step_once_at_a_value_width(b, s, h, kv, hd, hv,
                                                      causal):
    """The dK/dV grid the kernel walks (key tile by key tile, each (b, KV
    head)'s shares together) covers every (b, query head, key tile, query
    tile) step the mask keeps exactly once; the wide pair's key tile is
    64 keys and its fold slots hold one role's sum a consumer (any hv !=
    hd runs there)."""
    p = fa.plan(b, s, h, kv, hd, causal, hv=hv)
    tile = p.key_tile
    wide = hd != hv  # compiled at (192, 128)
    assert tile == (fa.WIDE_KEY_TILE if wide else fa.KEY_TILE)
    group, n_qt, n_kt = h // kv, -(-s // fa.QUERY_STEP), -(-s // tile)
    assert len(p.steps) == len(p.splits) == n_kt
    assert p.counters == b * kv * n_kt
    seen = set()
    blocks = 0
    for kt, ns in enumerate(p.splits):
        qt_first = kt * tile // fa.QUERY_STEP if causal else 0
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
            if not causal or qt >= kt * tile // fa.QUERY_STEP}
    assert seen == want
    hd_p = fa._hd_p(hd, hv)
    atoms = hd_p // 64 if wide else 2 * hd_p // 64
    per_block = 2 * 128 * 32 * atoms
    assert p.workspace_floats == (p.blocks * per_block
                                  if max(p.splits) > 1 else 0)
    assert p.dq_blocks == b * h * -(-s // fa.DQ_QUERY_TILE)
