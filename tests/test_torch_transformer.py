"""The port's dense transformer (repro_torch.models.transformer / layers)
against the JAX package's, on llama3-8b.reduced() (fp32, d 64, 4 layers,
4/2 heads, hd 16, vocab 512).

Weights are drawn by the reference's ``init_params`` and carried over by
``convert.params_from_jax``; tokens come from numpy.  On the CPU the port's
attention runs ``ops.flash_attention``'s plain version where the reference
runs ``layers.chunked_attention``.  Tolerance 1e-5 (rtol and atol): both
sides compute in fp32 and differ only in summation order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import transformer as jtf
from repro.sharding.rules import local_ctx
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import api, transformer
from repro_torch.models import layers as L

torch.set_num_threads(1)

CTX = local_ctx()
JCFG = jget_config("llama3-8b").reduced()
CFG = get_config("llama3-8b").reduced()
B, S = 2, 12
TOL = dict(rtol=1e-5, atol=1e-5)

_jinit = jax.jit(lambda key: japi.init_params(key, JCFG, CTX))
_jhidden = jax.jit(lambda p, t: jtf.hidden_states(p, t, JCFG, CTX)[0])
_jprefill = jax.jit(lambda p, t: jtf.prefill(p, t, JCFG, CTX, max_len=S + 4))
_jdecode = jax.jit(lambda p, t, c, pos: jtf.decode_step(p, t, c, pos, JCFG,
                                                        CTX))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    jp = _jinit(jax.random.PRNGKey(0))
    return jp, convert.params_from_jax(_np_tree(jp), CFG, device="cpu")


def _tokens(seed: int, s: int = S + 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (B, s)).astype(np.int32)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def test_config_matches_reference():
    assert dataclasses.asdict(get_config("llama3-8b")) == dataclasses.asdict(
        jget_config("llama3-8b"))
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_reference(dtype):
    """Same keys, stacked shapes and dtypes as the reference's init_lm."""
    jcfg = dataclasses.replace(JCFG, dtype=dtype, param_dtype=dtype)
    cfg = dataclasses.replace(CFG, dtype=dtype, param_dtype=dtype)
    want = jax.eval_shape(lambda k: japi.init_params(k, jcfg, CTX),
                          jax.random.PRNGKey(0))
    got = api.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_w] == \
        [jax.tree_util.keystr(p) for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), \
            jax.tree_util.keystr(path)
    # the head is its own table (untied), d_model wide
    assert api.head_table(got, cfg) is got["head"]["w"]
    assert api.hidden_width(cfg) == cfg.d_model


def test_bf16_params_convert_exactly():
    """bf16 leaves (numpy's ml_dtypes bfloat16) cross as bf16 tensors with
    the same values; the fp32 norm scales stay fp32."""
    jcfg = dataclasses.replace(JCFG, dtype="bfloat16",
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(CFG, dtype="bfloat16", param_dtype="bfloat16")
    jp = jax.jit(lambda key: japi.init_params(key, jcfg, CTX))(
        jax.random.PRNGKey(1))
    tp = convert.params_from_jax(_np_tree(jp), cfg, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert len(flat_w) == len(flat_g)
    dtypes = set()
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), \
            jax.tree_util.keystr(path)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
        dtypes.add(g.dtype)
    assert dtypes == {torch.bfloat16, torch.float32}


def test_hidden_states_match_jax(params):
    jp, tp = params
    tok = _tokens(0)
    want = np.asarray(_jhidden(jp, jnp.asarray(tok)))
    got, aux = transformer.hidden_states(tp, torch.from_numpy(tok).long(),
                                         CFG)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(aux) == 0.0


def test_prefill_h_and_caches_match_jax(params):
    jp, tp = params
    tok = _tokens(1, S)
    jh, jc = _jprefill(jp, jnp.asarray(tok))
    h, caches = transformer.prefill(tp, torch.from_numpy(tok).long(), CFG,
                                    max_len=S + 4)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    assert len(caches) == len(jc) == 1
    for name in ("k", "v"):
        assert caches[0][name].shape == jc[0][name].shape
        np.testing.assert_allclose(caches[0][name].numpy(),
                                   np.asarray(jc[0][name]), **TOL)


def test_decode_step_matches_jax(params):
    """Each side from its own prefill: h and both caches after one step."""
    jp, tp = params
    tok = _tokens(2)
    _, jc = _jprefill(jp, jnp.asarray(tok[:, :S]))
    _, caches = transformer.prefill(tp, torch.from_numpy(tok[:, :S]).long(),
                                    CFG, max_len=S + 4)
    pos = np.full((B,), S, np.int32)
    jh, jc = _jdecode(jp, jnp.asarray(tok[:, S:]), jc, jnp.asarray(pos))
    h, out = transformer.decode_step(tp, torch.from_numpy(tok[:, S:]).long(),
                                     caches, torch.from_numpy(pos).long(),
                                     CFG)
    assert out is caches  # written in place
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(caches[0][name].numpy(),
                                   np.asarray(jc[0][name]), **TOL)


@pytest.mark.parametrize("steps", [1, 4])
def test_prefill_then_decode_matches_full_forward(params, steps):
    """tests/test_serve.py's contract on the port alone: prefill h equals
    the forward's first S positions and each decode step's h the forward's
    at its position (RoPE positions, cache writes, masking)."""
    _, tp = params
    tok = torch.from_numpy(_tokens(3, S + steps)).long()
    h_full, _ = transformer.hidden_states(tp, tok, CFG)
    h_pre, caches = transformer.prefill(tp, tok[:, :S], CFG,
                                        max_len=S + steps)
    np.testing.assert_allclose(h_pre.numpy(), h_full[:, :S].numpy(), **TOL)
    for i in range(steps):
        pos = torch.full((B,), S + i, dtype=torch.long)
        h_dec, caches = transformer.decode_step(
            tp, tok[:, S + i:S + i + 1], caches, pos, CFG)
        np.testing.assert_allclose(h_dec[:, 0].numpy(),
                                   h_full[:, S + i].numpy(), **TOL)


def test_init_cache_shapes_match_jax():
    want = jtf.init_cache(JCFG, 3, 20, CTX)
    got = transformer.init_cache(CFG, 3, 20, device="cpu")
    assert [c["k"].shape for c in got] == [w["k"].shape for w in want]
    assert all(float(c["v"].abs().sum()) == 0.0 for c in got)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_matches_jax(theta):
    """Halves of hd rotated against each other (not interleaved pairs),
    at positions with an offset."""
    x = _normal(0, (2, 7, 3, 16))
    pos = (np.arange(7)[None, :] + np.array([[0], [40]])).astype(np.int32)
    want = np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match_jax(norm):
    jcfg = dataclasses.replace(JCFG, norm=norm)
    cfg = dataclasses.replace(CFG, norm=norm)
    x = _normal(1, (2, 5, 64), 3.0)
    jp = JL.init_norm(jcfg)
    jp = {k: v + jnp.asarray(_normal(2, v.shape, 0.1)) for k, v in jp.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert set(tp) == set(L.init_norm(cfg, torch.device("cpu")))
    want = np.asarray(JL.apply_norm(jp, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(
        L.apply_norm(tp, torch.from_numpy(x), cfg).numpy(), want, **TOL)
    want = np.asarray(JL.rms_norm_only(jnp.asarray(x), jp["scale"]))
    np.testing.assert_allclose(
        L.rms_norm_only(torch.from_numpy(x), tp["scale"]).numpy(), want,
        **TOL)


def test_norm_computes_in_fp32_and_casts_back():
    x = torch.from_numpy(_normal(3, (4, 64), 5.0)).to(torch.bfloat16)
    p = L.init_norm(CFG, torch.device("cpu"))
    got = L.apply_norm(p, x, CFG)
    assert got.dtype == torch.bfloat16
    x32 = x.float()
    want = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + 1e-6)
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_jax(act):
    """SwiGLU, and the plain MLP with jax.nn.gelu's default tanh form."""
    jcfg = dataclasses.replace(JCFG, act=act)
    cfg = dataclasses.replace(CFG, act=act)
    jp = JL.init_mlp(jax.random.PRNGKey(4), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert set(tp) == set(L.init_mlp(torch.Generator().manual_seed(0), cfg,
                                     torch.device("cpu")))
    x = _normal(5, (2, 3, 64), 2.0)
    want = np.asarray(JL.apply_mlp(jp, jnp.asarray(x), jcfg, CTX))
    got = L.apply_mlp(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if act == "gelu":  # the exact erf gelu would differ by far more
        exact = torch.nn.functional.gelu(torch.from_numpy(x) @ tp["w_up"])
        assert not np.allclose((exact @ tp["w_down"]).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_attention_layer_matches_jax():
    """attn_forward (through ops.flash_attention) and attn_decode against
    the reference's layers on converted attention weights."""
    jp = JL.init_attention(jax.random.PRNGKey(6), JCFG)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = _normal(7, (B, S, 64))
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want = np.asarray(JL.attn_forward(jp, jnp.asarray(x), jnp.asarray(pos),
                                      JCFG, CTX))
    got = L.attn_forward(tp, torch.from_numpy(x), torch.from_numpy(pos), CFG)
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    ck = _normal(8, (B, S + 2, 2, 16))
    cv = _normal(9, (B, S + 2, 2, 16))
    xd = _normal(10, (B, 1, 64))
    p1 = np.array([S - 3, S], np.int32)
    jy, jk, jv = JL.attn_decode(jp, jnp.asarray(xd), jnp.asarray(ck),
                                jnp.asarray(cv), jnp.asarray(p1), JCFG, CTX)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    y, k_out, v_out = L.attn_decode(tp, torch.from_numpy(xd), tk, tv,
                                    torch.from_numpy(p1).long(), CFG)
    assert k_out is tk and v_out is tv
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


#: MLA at the reduced deepseek-v3-671b's widths
MLA = dict(mla=True, q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16,
           qk_rope_dim=8, v_head_dim=16, head_dim=0)


@pytest.mark.parametrize("change", [
    dict(n_experts=4, moe_top_k=2, moe_d_ff=64), MLA,
    dict(mtp=True), dict(family="moe"),
    dict(family="hybrid", attn_layer_period=2, ssm_state=8),
    dict(learned_pos=True), dict(family="encdec")],
    ids=["moe", "mla", "mtp", "family-moe", "family-hybrid", "learned_pos",
         "encdec"])
def test_unported_transformer_parts_raise(change):
    """The decoder LM refuses only the encdec family, naming the module
    that runs it (``models/encdec.py``); MoE layers, MLA layers, the mtp
    subtree, the moe and hybrid families and learned positions (RoPE off,
    a ``pos_embed`` table added where the tree has one, on both sides)
    run, against the reference (1e-4 x max: four fp32 layers)."""
    cfg = dataclasses.replace(CFG, **change)
    if cfg.family == "encdec":
        with pytest.raises(NotImplementedError, match="models/encdec.py"):
            transformer.hidden_states(
                {}, torch.zeros((1, 2), dtype=torch.long), cfg)
        with pytest.raises(NotImplementedError, match="models/encdec.py"):
            transformer.init_cache(cfg, 1, 4, device="cpu")
        return
    jcfg = dataclasses.replace(JCFG, **change)
    jp = jax.jit(lambda k: japi.init_params(k, jcfg, CTX))(
        jax.random.PRNGKey(0))
    if cfg.learned_pos:
        # the reference's init_lm draws no table; one is added to both
        jp = dict(jp, pos_embed={"table": jnp.asarray(_normal(
            13, (S + 4, cfg.d_model), 0.5))})
    tp = convert.params_from_jax(_np_tree(jp), cfg, device="cpu")
    tok = _tokens(12)
    jh, jaux = jax.jit(lambda p, t: jtf.hidden_states(p, t, jcfg, CTX))(
        jp, jnp.asarray(tok))
    h, aux = transformer.hidden_states(tp, torch.from_numpy(tok).long(), cfg)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-4 * float(np.abs(jh).max()))
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=1e-5)
    want = jtf.init_cache(jcfg, B, 4, CTX, dtype=jnp.float32)
    got = transformer.init_cache(cfg, B, 4, device="cpu")
    assert jax.tree_util.tree_map(lambda v: tuple(v.shape), got) == \
        jax.tree_util.tree_map(lambda v: v.shape, want)
    if cfg.learned_pos:  # the table's rows at prefill and at a decode step
        jhp, jc = jax.jit(lambda p, t: jtf.prefill(p, t, jcfg, CTX,
                                                   max_len=S + 1))(
            jp, jnp.asarray(tok[:, :S]))
        hp, caches = transformer.prefill(tp, torch.from_numpy(
            tok[:, :S]).long(), cfg, max_len=S + 1)
        np.testing.assert_allclose(hp.numpy(), np.asarray(jhp), rtol=0,
                                   atol=1e-4 * float(np.abs(jhp).max()))
        pos = np.full((B,), S, np.int32)
        jhd, _ = jax.jit(lambda p, t, c, q: jtf.decode_step(
            p, t, c, q, jcfg, CTX))(jp, jnp.asarray(tok[:, S:]), jc,
                                    jnp.asarray(pos))
        hd, _ = transformer.decode_step(
            tp, torch.from_numpy(tok[:, S:]).long(), caches,
            torch.from_numpy(pos).long(), cfg)
        np.testing.assert_allclose(hd.numpy(), np.asarray(jhd), rtol=0,
                                   atol=1e-4 * float(np.abs(jhd).max()))
        np.testing.assert_allclose(hd[:, 0].numpy(), h[:, S].numpy(),
                                   rtol=0, atol=1e-4 * float(
                                       np.abs(jh).max()))
        module = transformer.StackedLM(cfg, "cpu", tree=tp)
        assert module.pos_embed.table.data_ptr() == \
            tp["pos_embed"]["table"].data_ptr()
        hm, _ = transformer.hidden_states(module, torch.from_numpy(
            tok).long(), cfg)
        assert torch.equal(hm, h)
        np.testing.assert_array_equal(convert.params_to_jax(module)[
            "pos_embed"]["table"], np.asarray(jp["pos_embed"]["table"]))


def test_backbone_hidden_flattens_tokens(params):
    _, tp = params
    tok = torch.from_numpy(_tokens(11)).long()
    h, labels, aux = api.backbone_hidden(tp, {"tokens": tok, "labels": tok},
                                         CFG)
    assert h.shape == (B * (S + 1), CFG.d_model)
    assert torch.equal(labels, tok.reshape(-1))
    h_full, _ = transformer.hidden_states(tp, tok, CFG)
    assert torch.equal(h, h_full.reshape(-1, CFG.d_model))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(CFG, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_cache(CFG, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_jax({"segments": [{}]}, CFG)
