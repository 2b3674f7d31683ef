"""The MoE, SSM and hybrid families' serving path in the port
(repro_torch.models.transformer, repro_torch.serve.engine) against the JAX
package's, on falcon-mamba-7b.reduced() (4 mamba+none layers),
jamba-v0.1-52b.reduced() (8 layers: attention at 4, MoE at every odd
layer, mamba+mlp between) and dbrx-132b.reduced() (4 attn+moe layers),
fp32, at the configs' capacity factor of 1.25 and at 16 (where no
assignment drops).

Weights are drawn by the reference's ``init_params`` and carried over by
``convert.params_from_jax``; tokens come from numpy.  Hidden states,
prefill caches and decode within 1e-4 x max|reference| (the whole-model
tolerance of test_torch_dense_train.py: both sides in fp32, summation
orders apart, through up to 8 layers); greedy and top-k ids equal.

The reference's prefill stores the mamba state after the scan's padding
(to a multiple of 256), not after the prompt's last token (ROADMAP.md C):
``test_decode_after_a_long_prompt`` holds the port's decode after a
300-token prompt to the reference's forward, and shows that the
reference's own decode misses it.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro.sharding.rules import local_ctx
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import api, transformer
from repro_torch.serve import engine, retrieval

torch.set_num_threads(1)

CTX = local_ctx()
B, S = 2, 12
TOL = 1e-4
CASES = [("falcon-mamba-7b", 1.25), ("jamba-v0.1-52b", 1.25),
         ("jamba-v0.1-52b", 16.0), ("dbrx-132b", 1.25), ("dbrx-132b", 16.0)]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _model(arch: str, factor: float):
    """(reference cfg, port cfg, reference params, port params, the
    reference's jitted hidden_states / prefill / decode_step)."""
    jcfg = jget_config(arch).reduced(capacity_factor=factor)
    cfg = get_config(arch).reduced(capacity_factor=factor)
    jp = jax.jit(lambda k: japi.init_params(k, jcfg, CTX))(
        jax.random.PRNGKey(0))
    tp = convert.params_from_jax(_np_tree(jp), cfg, device="cpu")
    fns = types.SimpleNamespace(
        hidden=jax.jit(lambda p, t: jtf.hidden_states(p, t, jcfg, CTX)),
        prefill=jax.jit(lambda p, t, n: jtf.prefill(p, t, jcfg, CTX,
                                                    max_len=n),
                        static_argnums=2),
        decode=jax.jit(lambda p, t, c, pos: jtf.decode_step(
            p, t, c, pos, jcfg, CTX)))
    return jcfg, cfg, jp, tp, fns


def _tokens(seed: int, s: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, s)).astype(
        np.int32)


def _check_caches(got, want):
    want = _np_tree(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            assert g[k].dtype == torch.float32
            _close(g[k].numpy(), w[k])


@pytest.mark.parametrize("arch,factor", CASES)
def test_hidden_prefill_decode_match_jax(arch, factor):
    jcfg, cfg, jp, tp, jf = _model(arch, factor)
    tok = _tokens(1, S + 1, cfg.vocab_size)
    jh, jaux = jf.hidden(jp, jnp.asarray(tok))
    h, aux = transformer.hidden_states(tp, torch.from_numpy(tok).long(), cfg)
    _close(h.numpy(), jh)
    _close(aux.numpy(), jaux)
    if cfg.n_experts:
        assert float(aux) > 0

    jhp, jc = jf.prefill(jp, jnp.asarray(tok[:, :S]), S + 3)
    hp, caches = transformer.prefill(tp, torch.from_numpy(tok[:, :S]).long(),
                                     cfg, max_len=S + 3)
    _close(hp.numpy(), jhp)
    _check_caches(caches, jc)

    pos = np.full((B,), S, np.int32)
    jhd, jc2 = jf.decode(jp, jnp.asarray(tok[:, S:]), jc, jnp.asarray(pos))
    hd, caches2 = transformer.decode_step(
        tp, torch.from_numpy(tok[:, S:]).long(), caches,
        torch.from_numpy(pos).long(), cfg)
    _close(hd.numpy(), jhd)
    _check_caches(caches2, jc2)
    if factor >= 16:  # nothing drops: decode continues the forward
        _close(hd[:, 0].numpy(), np.asarray(jh)[:, S])
        _close(hp.numpy(), np.asarray(jh)[:, :S])


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_decode_after_a_long_prompt(arch):
    """A 300-token prompt (longer than the scan's 256-step chunk, not a
    multiple of it): the port's decode at position 300 equals the
    reference's forward there; the reference's decode does not."""
    jcfg, cfg, jp, tp, jf = _model(arch, 16.0)
    s = 300
    tok = _tokens(2, s + 1, cfg.vocab_size)
    jh, _ = jf.hidden(jp, jnp.asarray(tok))
    want = np.asarray(jh)[:, s]
    _, caches = transformer.prefill(tp, torch.from_numpy(tok[:, :s]).long(),
                                    cfg, max_len=s + 1)
    pos = np.full((B,), s, np.int32)
    hd, _ = transformer.decode_step(tp, torch.from_numpy(tok[:, s:]).long(),
                                    caches, torch.from_numpy(pos).long(), cfg)
    _close(hd[:, 0].numpy(), want)
    _, jc = jf.prefill(jp, jnp.asarray(tok[:, :s]), s + 1)
    jhd, _ = jf.decode(jp, jnp.asarray(tok[:, s:]), jc, jnp.asarray(pos))
    gap = float(np.abs(np.asarray(jhd)[:, 0] - want).max())
    assert gap > 10 * TOL * float(np.abs(want).max())


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_convert_both_ways(arch):
    jcfg, cfg, jp, tp, jf = _model(arch, 1.25)
    back = convert.params_to_jax(tp)
    want = _np_tree(jp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the reference's leaf dtypes, in bf16
    bcfg = get_config(arch).reduced(dtype="bfloat16", param_dtype="bfloat16")
    bj = jax.eval_shape(lambda k: japi.init_params(
        k, jget_config(arch).reduced(dtype="bfloat16",
                                     param_dtype="bfloat16"), CTX),
        jax.random.PRNGKey(0))
    bp = api.init_params(bcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(bj)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(bp)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
    # caches both ways
    tok = _tokens(3, S, cfg.vocab_size)
    _, jc = jf.prefill(jp, jnp.asarray(tok), S + 2)
    tc = convert.caches_from_jax(_np_tree(jc), cfg, device="cpu")
    for g, w in zip(jax.tree_util.tree_leaves(convert.caches_to_jax(tc)),
                    jax.tree_util.tree_leaves(_np_tree(jc))):
        np.testing.assert_array_equal(g, w)
    assert [set(c) for c in tc] == [
        {"k", "v"} if kind.startswith("attn") else {"conv", "ssm"}
        for kind, _ in transformer.segments_of(cfg)]


def test_init_cache_matches_reference_layout():
    jcfg, cfg, *_ = _model("jamba-v0.1-52b", 1.25)
    bf = torch.bfloat16
    want = jtf.init_cache(jcfg, B, 20, CTX, dtype=jnp.bfloat16)
    got = transformer.init_cache(cfg, B, 20, dtype=bf, device="cpu")
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            assert tuple(g[k].shape) == w[k].shape
            assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype)
    assert {str(c["ssm"].dtype) for c in got if "ssm" in c} == {
        "torch.float32"}


def test_engine_steps_through_the_index_at_full_beam():
    """Prefill, greedy decode and top-k through a RetrievalIndex at full
    beam on jamba reduced: greedy ids equal the reference engine's, the
    index's top-k equals the dense top-k and its top-1 the greedy token."""
    jcfg, cfg, jp, tp, jf = _model("jamba-v0.1-52b", 1.25)
    steps, k, max_len = 4, 5, S + 6
    prompt = _tokens(4, S, cfg.vocab_size)
    jtok, jc = jax.jit(jengine.make_prefill_step(jcfg, CTX, max_len))(
        jp, {"tokens": jnp.asarray(prompt)})
    tok, caches = engine.make_prefill_step(cfg, None, max_len)(
        tp, {"tokens": torch.from_numpy(prompt).long()})
    jdec = jax.jit(jengine.make_decode_step(jcfg, CTX))
    decode = engine.make_decode_step(cfg, None)
    for i in range(steps):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        pos = np.full((B,), S + i, np.int32)
        jtok, jc = jdec(jp, jtok[:, None], jc, jnp.asarray(pos))
        tok, caches = decode(tp, tok[:, None].long(), caches,
                             torch.from_numpy(pos).long())
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    pos = torch.full((B,), S + steps, dtype=torch.long)
    index = retrieval.build_index(api.head_table(tp, cfg))
    assert index.num_leaves_shard > 1
    ids, logits, _ = engine.make_topk_step(cfg, None, k, index=index)(
        tp, tok[:, None].long(), caches, pos)
    dids, dlogits, _ = engine.make_topk_step(cfg, None, k)(
        tp, tok[:, None].long(), caches, pos)
    np.testing.assert_array_equal(ids.numpy(), dids.numpy())
    _close(logits.numpy(), dlogits.numpy(), 1e-5)
    # the mamba states were not advanced by the repeated steps
    nxt, _ = decode(tp, tok[:, None].long(), caches, pos)
    np.testing.assert_array_equal(ids[:, 0].numpy(), nxt.numpy())


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("jamba-v0.1-52b").reduced()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(cfg, gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_jax({"segments": []}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.caches_from_jax([], cfg)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b",
                                  "dbrx-132b"])
def test_the_new_families_serve_but_do_not_train(arch):
    """Since the families train, init_module, the training entry, gives
    their StackedLM over the stacked tree (no copy), and abstract_params
    the same module on the meta device."""
    cfg = get_config(arch).reduced()
    model = api.init_module(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert isinstance(model, transformer.StackedLM)
    meta = api.abstract_params(cfg)
    assert isinstance(meta, transformer.StackedLM)
    real = api.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    flat_r = jax.tree_util.tree_leaves(real)
    flat_m = [p for _, p in meta.named_parameters()]
    assert sorted((n, p.shape, p.dtype) for n, p in meta.named_parameters()
                  ) == sorted((n, p.shape, p.dtype)
                              for n, p in model.named_parameters())
    assert sum(p.numel() for p in flat_m) == sum(t.numel() for t in flat_r)
    assert {t.device.type for t in flat_m} == {"meta"}
