"""The port's mamba block (repro_torch.models.mamba) against the JAX
package's (repro.models.mamba), on falcon-mamba-7b.reduced() and
jamba-v0.1-52b.reduced() (fp32, d 64, d_inner 128, state 8, dt rank 8).

Weights come from the reference's ``init_mamba_full`` with the zero conv
bias, the constant dt bias and the unit skip replaced by seeded numpy
draws; inputs from numpy.  Tolerance 1e-5 x max|reference| everywhere:
both sides compute in fp32 and differ only in summation order (the scan's
tree of products among them).

The reference's chunked scan pads the sequence to a multiple of its chunk,
and the state it returns is the state after that padding; the port's is
the state after the last token (ROADMAP.md C).  ``test_scan_noskip``
holds both: where S <= chunk or S % chunk == 0 the two agree; at S = 300
the port's equals the reference's scan at a chunk of at least S, and the
reference's chunk-256 state is shown to differ.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import mamba as JM
from repro.sharding.rules import local_ctx
from repro_torch.configs import get_config
from repro_torch.models import mamba as M

torch.set_num_threads(1)

CTX = local_ctx()
ARCHS = ["falcon-mamba-7b", "jamba-v0.1-52b"]
B = 2


def _cfgs(arch):
    return jget_config(arch).reduced(), get_config(arch).reduced()


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, cfg = _cfgs(request.param)
    jp = jax.jit(lambda k: JM.init_mamba_full(k, jcfg))(jax.random.PRNGKey(3))
    jp = {k: np.asarray(v) for k, v in jp.items()}
    di = jcfg.d_inner
    jp["conv_b"] = _normal(1, (di,), 0.1)
    jp["dt_bias"] = np.log(np.expm1(np.random.default_rng(2).uniform(
        1e-3, 1e-1, di))).astype(np.float32)
    jp["d"] = _normal(3, (di,))
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    return jcfg, cfg, {k: jnp.asarray(v) for k, v in jp.items()}, tp


def test_config_matches_reference():
    for arch in ARCHS + ["dbrx-132b"]:
        jcfg, cfg = jget_config(arch), get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
            jcfg.reduced())
        for c, jc in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
            assert c.layer_kinds() == jc.layer_kinds()
            assert (c.d_inner, c.dt_rank) == (jc.d_inner, jc.dt_rank)
    kinds = get_config("jamba-v0.1-52b").layer_kinds()
    assert [i for i, k in enumerate(kinds) if k.startswith("attn")] == [
        4, 12, 20, 28]
    assert [i for i, k in enumerate(kinds) if k.endswith("moe")] == list(
        range(1, 32, 2))
    cut = get_config("jamba-v0.1-52b").reduced()
    assert cut.n_layers == 8 and cut.layer_kinds()[4] == "attn+mlp"
    assert set(get_config("falcon-mamba-7b").layer_kinds()) == {
        "mamba+none"}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_tree(arch):
    jcfg, cfg = _cfgs(arch)
    want = jax.eval_shape(lambda k: JM.init_mamba_full(k, jcfg),
                          jax.random.PRNGKey(0))
    got = M.init_mamba_full(torch.Generator().manual_seed(0), cfg,
                            torch.device("cpu"))
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
    jp = JM.init_mamba(jax.random.PRNGKey(0), jcfg)
    for k in ("dt_bias", "a_log", "d", "conv_b"):
        _close(got[k].numpy(), np.asarray(jp[k]))
    cache = M.init_mamba_cache(cfg, B, torch.float32, torch.device("cpu"))
    jcache = JM.init_mamba_cache(jcfg, B, jnp.float32)
    for k in ("conv", "ssm"):
        assert tuple(cache[k].shape) == jcache[k].shape
        assert not cache[k].any()


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv(setup, with_prev):
    jcfg, cfg, jp, tp = setup
    x = _normal(4, (B, 7, cfg.d_inner))
    prev = _normal(5, (B, cfg.ssm_conv - 1, cfg.d_inner)) if with_prev \
        else None
    jy, jw = JM._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"],
                             None if prev is None else jnp.asarray(prev))
    y, w = M._causal_conv(torch.from_numpy(x), tp["conv_w"], tp["conv_b"],
                          None if prev is None else torch.from_numpy(prev))
    _close(y.numpy(), jy)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def test_ssm_params(setup):
    jcfg, cfg, jp, tp = setup
    xc = _normal(6, (B, 9, cfg.d_inner))
    want = JM._ssm_params(jp, jnp.asarray(xc), jcfg)
    got = M._ssm_params(tp, torch.from_numpy(xc), cfg)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w)


def test_scan_chunk(setup):
    jcfg, cfg, jp, tp = setup
    n, di, L = cfg.ssm_state, cfg.d_inner, 37
    a = np.exp(-np.abs(_normal(7, (B, L, di, n))))
    bx = _normal(8, (B, L, di, n))
    h0 = _normal(9, (B, di, n))
    jh, jlast = jax.jit(JM._scan_chunk)(jnp.asarray(a), jnp.asarray(bx),
                                        jnp.asarray(h0))
    h, last = M._scan_chunk(torch.from_numpy(a), torch.from_numpy(bx.copy()),
                            torch.from_numpy(h0))
    _close(h.numpy(), jh)
    _close(last.numpy(), jlast)


_jscan = jax.jit(JM._scan_noskip, static_argnums=(2,),
                 static_argnames=("chunk",))


@pytest.mark.parametrize("s", [200, 256, 300, 512])
def test_scan_noskip(setup, s):
    jcfg, cfg, jp, tp = setup
    xc = _normal(10 + s, (B, s, cfg.d_inner))
    h0 = _normal(11, (B, cfg.d_inner, cfg.ssm_state))
    jy, jlast = _jscan(jp, jnp.asarray(xc), jcfg, jnp.asarray(h0), chunk=256)
    y, last = M._scan_noskip(tp, torch.from_numpy(xc), cfg,
                             torch.from_numpy(h0), chunk=256)
    _close(y.numpy(), jy)
    if s <= 256 or s % 256 == 0:
        _close(last.numpy(), jlast)
    else:
        # the state after the last token: the reference's scan in one chunk
        _, jexact = _jscan(jp, jnp.asarray(xc), jcfg, jnp.asarray(h0),
                           chunk=512)
        _close(last.numpy(), jexact)
        gap = float(np.abs(np.asarray(jlast) - np.asarray(jexact)).max())
        assert gap > 0.1 * float(np.abs(np.asarray(jexact)).max())


def test_apply_mamba(setup):
    jcfg, cfg, jp, tp = setup
    x = _normal(12, (B, 300, cfg.d_model))
    want = jax.jit(lambda p, x: JM.apply_mamba(p, x, jcfg, CTX))(
        jp, jnp.asarray(x))
    _close(M.apply_mamba(tp, torch.from_numpy(x), cfg).numpy(), want)


def test_mamba_decode(setup):
    jcfg, cfg, jp, tp = setup
    x = _normal(13, (B, 1, cfg.d_model))
    conv = _normal(14, (B, cfg.ssm_conv - 1, cfg.d_inner))
    ssm = _normal(15, (B, cfg.d_inner, cfg.ssm_state))
    jy, jc = jax.jit(lambda p, x, c: JM.mamba_decode(p, x, c, jcfg, CTX))(
        jp, jnp.asarray(x), {"conv": jnp.asarray(conv),
                             "ssm": jnp.asarray(ssm)})
    cache = {"conv": torch.from_numpy(conv), "ssm": torch.from_numpy(ssm)}
    y, c = M.mamba_decode(tp, torch.from_numpy(x), cache, cfg)
    _close(y.numpy(), jy)
    np.testing.assert_array_equal(c["conv"].numpy(), np.asarray(jc["conv"]))
    _close(c["ssm"].numpy(), jc["ssm"])
    # the given cache is left as it was
    np.testing.assert_array_equal(cache["ssm"].numpy(), ssm)


def test_decode_chain_matches_apply_mamba(setup):
    """Token-by-token decode from the zero cache reproduces the full
    sequence, and its last state is the prefill's."""
    jcfg, cfg, jp, tp = setup
    s = 40
    x = torch.from_numpy(_normal(16, (B, s, cfg.d_model)))
    y_full, cache_pre = M.mamba_prefill(tp, x, cfg, chunk=16)
    _close(y_full.numpy(), M.apply_mamba(tp, x, cfg).numpy())
    cache = M.init_mamba_cache(cfg, B, torch.float32, torch.device("cpu"))
    ys = []
    for t in range(s):
        y, cache = M.mamba_decode(tp, x[:, t:t + 1], cache, cfg)
        ys.append(y)
    _close(torch.cat(ys, dim=1).numpy(), y_full.numpy())
    _close(cache["ssm"].numpy(), cache_pre["ssm"].numpy())
    _close(cache["conv"].numpy(), cache_pre["conv"].numpy())
