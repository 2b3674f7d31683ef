"""deepseek-v3-671b in the port (MLA layers, the mtp trunk, the MoE layers
with a shared expert and sigmoid routing) against the JAX package, at
``reduced()`` sizes on the CPU, fp32: 4 layers (1 dense ``attn+mlp``, 3
``attn+moe``), d 64, 4 heads of q/k width 24 and value width 16, 4
experts top-2 and 1 shared, capacity factor 1.25 (assignments drop).

* The init tree (with ``mtp``), in fp32 and bf16, against the
  reference's: keys, shapes, dtypes.
* ``hidden_states``, ``prefill`` (h and the latent caches) and
  ``decode_step`` (h and the caches it writes) against the reference's,
  within 1e-4 x max|ref| (fp32 through 4 layers, the tolerance of
  ``test_torch_hybrid_serving.py``); at a capacity where nothing drops,
  decode continues the forward.
* ``mtp_hidden`` and the mtp rows of ``backbone_hidden`` (T = B (2S - 2),
  the labels shifted twice) against the reference's, 1e-4 x max.
* ``convert`` both ways: params (a ``StackedLM`` too), latent caches and
  an Adafactor train state, bitwise.
* One train step at fixed shared negatives with clip + Adafactor: the
  loss and every parameter's gradient (the mtp block's included) within
  1e-5 x max|ref|, every parameter after the step within 1e-5 (rtol and
  atol), Adafactor's statistics within 2e-5 x max|ref|; clip and
  Adafactor in row pieces against whole matrices, 1e-6.
* The remat path bitwise equal to the plain one; ``fit`` with the mtp
  rows; the three engine steps (prefill, greedy decode, top-k through the
  index at full beam) against the reference engine's tokens.

Weights come from the reference's ``init_params`` (norm scales and the
router bias perturbed off their constant inits); tokens and the other
inputs from numpy seeds.  The JAX side runs under ``jax.jit``.
"""
import dataclasses
import functools
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import estimators as jest
from repro.models import api as japi
from repro.models import transformer as jtf
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim.transform import apply_updates as japply_updates
from repro.serve import engine as jengine
from repro.sharding.rules import local_ctx
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import estimators
from repro_torch.data.pipeline import batch_iterator_for
from repro_torch.models import api, moe, transformer
from repro_torch.optim import make_optimizer
from repro_torch.optim.transform import apply_updates
from repro_torch.serve import engine, retrieval
from repro_torch.train import loop, step

torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"
CTX = local_ctx()
JCFG = jget_config(ARCH).reduced()
CFG = get_config(ARCH).reduced()
B, S = 2, 12
TOL = 1e-4
STEP_TOL = 1e-5
STATS_TOL = 2 * STEP_TOL
#: the train step's weight of the MoE aux (``make_train_step``'s default)
AUX_COEF = 0.01


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL, msg=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, msg
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{msg}: max |got - want| {err} > {bound}"


def _perturbed(np_params, seed):
    """Norm scales off 1 and the router bias off 0 (by less than the
    routing scores vary over tokens, so that every expert is picked)."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if name == "scale":
            return (1.0 + rng.normal(size=node.shape) * 0.1
                    ).astype(node.dtype)
        if name == "router_bias":
            return (rng.normal(size=node.shape) * 1e-3).astype(node.dtype)
        return node
    return walk(np_params)


@functools.lru_cache(maxsize=None)
def _model():
    """(reference params, port params, the reference's jitted functions)."""
    jp = _perturbed(_np_tree(jax.jit(lambda k: japi.init_params(
        k, JCFG, CTX))(jax.random.PRNGKey(0))), 1)
    tp = convert.params_from_jax(jp, CFG, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    fns = types.SimpleNamespace(
        hidden=jax.jit(lambda p, t: jtf.hidden_states(p, t, JCFG, CTX)),
        prefill=jax.jit(lambda p, t, n: jtf.prefill(p, t, JCFG, CTX,
                                                    max_len=n),
                        static_argnums=2),
        decode=jax.jit(lambda p, t, c, pos: jtf.decode_step(
            p, t, c, pos, JCFG, CTX)),
        backbone=jax.jit(lambda p, b: japi.backbone_hidden(p, b, JCFG,
                                                           CTX)))
    return jp, tp, fns


def _tokens(seed: int, s: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (B, s)).astype(np.int32)


def _tensor(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_reference(dtype):
    """Same keys (``mtp`` with its projection, norms and one ``attn+mlp``
    block), stacked shapes and dtypes as the reference's init_lm."""
    jcfg = dataclasses.replace(JCFG, dtype=dtype, param_dtype=dtype)
    cfg = dataclasses.replace(CFG, dtype=dtype, param_dtype=dtype)
    want = jax.eval_shape(lambda k: japi.init_params(k, jcfg, CTX),
                          jax.random.PRNGKey(0))
    got = api.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert set(got["mtp"]) == {"proj", "norm_h", "norm_e", "block",
                               "final_norm"}
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
    meta = api.abstract_params(cfg)
    assert [n for n, _ in meta.named_parameters()] == [
        n for n, _ in transformer.StackedLM(cfg, "cpu", tree=got)
        .named_parameters()]


def test_hidden_prefill_decode_and_latent_caches_match_jax():
    jp, tp, jf = _model()
    tok = _tokens(2, S + 1)
    jh, jaux = jf.hidden(jp, jnp.asarray(tok))
    h, aux = transformer.hidden_states(tp, _tensor(tok), CFG)
    _close(h.numpy(), jh, msg="h")
    assert float(jaux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)

    jhp, jc = jf.prefill(jp, jnp.asarray(tok[:, :S]), S + 3)
    hp, caches = transformer.prefill(tp, _tensor(tok[:, :S]), CFG,
                                     max_len=S + 3)
    _close(hp.numpy(), jhp, msg="prefill h")
    lat = CFG.kv_lora_rank + CFG.qk_rope_dim
    assert [tuple(c.shape) for c in caches] == [
        (n, B, S + 3, lat) for _, n in transformer.segments_of(CFG)]
    for g, w in zip(caches, jc):
        _close(g.numpy(), w, msg="prefill cache")
        assert not g[:, :, S:].any()

    pos = np.full((B,), S, np.int32)
    jhd, jc2 = jf.decode(jp, jnp.asarray(tok[:, S:]), jc, jnp.asarray(pos))
    hd, caches2 = transformer.decode_step(tp, _tensor(tok[:, S:]), caches,
                                          _tensor(pos), CFG)
    assert caches2 is caches  # written in place
    _close(hd.numpy(), jhd, msg="decode h")
    for g, w in zip(caches2, jc2):
        _close(g.numpy(), w, msg="decode cache")


def test_decode_continues_the_forward_where_nothing_drops():
    """At capacity factor 16 no assignment drops at either T, so the
    absorbed decode over the latent cache gives the expanded forward's h
    at its position (the port against itself; 1e-4 x max)."""
    _, tp, _ = _model()
    cfg = dataclasses.replace(CFG, capacity_factor=16.0)
    tok = _tensor(_tokens(3, S + 2))
    h, _ = transformer.hidden_states(tp, tok, cfg)
    hp, caches = transformer.prefill(tp, tok[:, :S], cfg, max_len=S + 2)
    _close(hp.numpy(), h[:, :S].numpy())
    for t in (S, S + 1):
        pos = torch.full((B,), t, dtype=torch.long)
        hd, caches = transformer.decode_step(tp, tok[:, t:t + 1], caches,
                                             pos, cfg)
        _close(hd[:, 0].numpy(), h[:, t].numpy(), msg=f"decode at {t}")


def test_mtp_rows_match_reference():
    """``mtp_hidden`` (B, S - 1, d) and ``backbone_hidden``'s rows: the
    backbone's B S, then the mtp trunk's h[:, :-1] with labels[:, 2:]."""
    jp, tp, jf = _model()
    tok, lab = _tokens(4, S), _tokens(5, S)
    jh, _ = jf.hidden(jp, jnp.asarray(tok))
    jm = jax.jit(lambda p, h, t: jtf.mtp_hidden(p, h, t, JCFG, CTX))(
        jp, jh, jnp.asarray(tok))
    h, _ = transformer.hidden_states(tp, _tensor(tok), CFG)
    m = transformer.mtp_hidden(tp, h, _tensor(tok), CFG)
    assert m.shape == (B, S - 1, CFG.d_model)
    _close(m.numpy(), jm, msg="mtp h")
    jrows, jlabels, jaux = jf.backbone(jp, {"tokens": jnp.asarray(tok),
                                            "labels": jnp.asarray(lab)})
    rows, labels, aux = api.backbone_hidden(
        tp, {"tokens": _tensor(tok), "labels": _tensor(lab)}, CFG)
    assert rows.shape == (B * (2 * S - 2), CFG.d_model)
    _close(rows.numpy(), jrows, msg="rows")
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_array_equal(labels[B * S:].numpy(),
                                  lab[:, 2:].reshape(-1))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_convert_params_and_latent_caches_both_ways():
    jp, tp, jf = _model()
    want = _np_tree(jp)
    for back in (convert.params_to_jax(tp), convert.params_to_jax(
            transformer.StackedLM(CFG, "cpu", tree=tp))):
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(want)
        for g, w in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(want)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    _, jc = jf.prefill(jp, jnp.asarray(_tokens(6, S)), S + 2)
    tc = convert.caches_from_jax(_np_tree(jc), CFG, device="cpu")
    assert all(isinstance(c, torch.Tensor) for c in tc)
    for g, w in zip(convert.caches_to_jax(tc), _np_tree(jc)):
        np.testing.assert_array_equal(g, w)
    bf = torch.bfloat16
    got = transformer.init_cache(CFG, B, 20, dtype=bf, device="cpu")
    ref_c = jtf.init_cache(JCFG, B, 20, CTX, dtype=jnp.bfloat16)
    assert [(tuple(g.shape), g.dtype) for g in got] == [
        (w.shape, bf) for w in ref_c]


# --- one train step at fixed negatives, then clip + Adafactor ----------------


@functools.lru_cache(maxsize=None)
def _ref_state():
    jopt = jmake_optimizer("adafactor", 1e-2)
    state = jax.jit(lambda key: jstep.init_train_state(key, JCFG, CTX, jopt,
                                                       max_len=8))(
        jax.random.PRNGKey(0))
    params = _perturbed(_np_tree(state.params), 4)
    return jopt, dataclasses.replace(
        state, params=jax.tree_util.tree_map(jnp.asarray, params))


def _train_state(jstate):
    return convert.train_state_from_jax(
        _np_tree(jstate.params), _np_tree(jstate.opt_state),
        {"stats": _np_tree(jstate.sampler_state.stats),
         "const": _np_tree(jstate.sampler_state.const)}, 3, CFG,
        device="cpu")


def test_adafactor_train_state_converts_both_ways():
    """The chain(clip, adafactor) state over the MLA weights and the
    unstacked mtp subtree (its 2-D matrices factored one at a time, its
    norms unfactored) crosses both ways bitwise, in the reference's tree."""
    _, jstate = _ref_state()
    mine = _train_state(jstate)
    assert isinstance(mine.params, transformer.StackedLM)
    v = mine.opt_state[1]["v"]
    assert set(v["mtp.proj"]) == {"vr", "vc"}
    assert v["mtp.proj"]["vr"].shape == (2 * CFG.d_model,)
    assert set(v["mtp.block.attn.kv_a_norm.scale"]) == {"v"}
    assert v["segments.1.attn.wkv_b"]["vr"].shape == (
        3, CFG.kv_lora_rank)
    params, opt_state, sampler, n = convert.train_state_to_jax(mine)
    assert n == 3
    for got, want in ((params, jstate.params),
                      (opt_state, jstate.opt_state),
                      (sampler["stats"], jstate.sampler_state.stats)):
        want = _np_tree(want)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g, w)


def _fixed_negative_step(jopt, jstate):
    """One train step of each package from the same state, at the same
    fixed shared negatives (clip + Adafactor, lr 1e-2): the losses, the
    port's gradients by name and the reference's tree, both states after
    the step, and the expert ids each MoE layer of the port routed to."""
    opt = make_optimizer("adafactor", 1e-2)
    mine = _train_state(jstate)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    batch_np = {"tokens": tokens, "labels": labels}
    m = CFG.m_negatives
    neg = rng.choice(CFG.vocab_size, m, replace=False).astype(np.int32)
    logq = np.log(rng.uniform(1e-4, 1e-2, m)).astype(np.float32)

    def jloss(params):
        hh, lab, aux = japi.backbone_hidden(params, batch_np, JCFG, CTX)
        loss = jnp.mean(jest.loss_from_embeddings(
            jest.make_estimator(JCFG.estimator),
            japi.head_table(params, JCFG), hh, lab, neg, logq,
            abs_mode=JCFG.abs_softmax))
        return loss + AUX_COEF * aux

    @jax.jit
    def jstep_fn(params, opt_state):
        loss, grads = jax.value_and_grad(jloss)(params)
        upd, opt_state = jopt.update(grads, opt_state, params)
        return loss, grads, japply_updates(params, upd), opt_state
    jl, jgrads, jparams, jopt_state = jstep_fn(jstate.params,
                                               jstate.opt_state)

    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in batch_np.items()}
    picked = []
    real = moe._route

    def route(p, x, c):
        out = real(p, x, c)
        picked.append(out[0])
        return out
    moe._route = route
    try:
        hh, lab, aux = api.backbone_hidden(mine.params, batch, CFG)
    finally:
        moe._route = real
    assert hh.shape[0] == B * (2 * S - 2)
    loss = torch.mean(estimators.loss_from_embeddings(
        estimators.make_estimator(CFG.estimator),
        api.head_table(mine.params, CFG), hh, lab,
        torch.from_numpy(neg.astype(np.int64)), torch.from_numpy(logq),
        abs_mode=CFG.abs_softmax, impl=CFG.head_impl)) + AUX_COEF * aux
    params = step.param_dict(mine.params)
    # the router bias only picks the top-k: no gradient reaches it, in
    # either package (the step takes zeros for it)
    grads = dict(zip(params, (
        torch.zeros_like(p) if g is None else g for p, g in zip(
            params.values(), torch.autograd.grad(
                loss, list(params.values()), allow_unused=True)))))
    assert [n for n in params if grads[n].abs().max() == 0] == [
        f"segments.1.{i}.moe.router_bias" for i in range(3)]
    # the port's clip consumes its input: the step gets copies
    upd, opt_state = opt.update({k: g.clone() for k, g in grads.items()},
                                mine.opt_state, params)
    apply_updates(params, upd)
    return types.SimpleNamespace(
        loss=loss.item(), jloss=float(jl), grads=grads, jgrads=jgrads,
        state=dataclasses.replace(mine, opt_state=opt_state),
        jparams=jparams, jopt_state=jopt_state, picked=picked)


def _router_columns(tree):
    """The MoE layers' router stack, (layers, d, experts), of a reference
    tree."""
    return np.asarray(tree["segments"][1]["moe"]["router"], np.float32)


def _compare_step(r, skip=()):
    """The losses, every gradient within 1e-5 x max|ref|; every parameter
    after the step within 1e-5 (rtol and atol) and Adafactor's statistics
    within 2e-5 x max|ref|, but for the parameters whose path holds one
    of ``skip``."""
    _close(r.loss, r.jloss, STEP_TOL, "loss")
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(convert.named_to_jax(
                r.state.params, r.grads))[0],
            jax.tree_util.tree_flatten_with_path(_np_tree(r.jgrads))[0]):
        _close(g, w, STEP_TOL, "grad " + jax.tree_util.keystr(path))
    got = convert.params_to_jax(r.state.params)
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(_np_tree(r.jparams))[0]):
        if any(k in jax.tree_util.keystr(path) for k in skip):
            continue
        np.testing.assert_allclose(g, w, rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    _, back, _, _ = convert.train_state_to_jax(r.state)
    for (path, g), (p2, w) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(_np_tree(r.jopt_state))[0]):
        assert path == p2
        _close(g, w, STATS_TOL, jax.tree_util.keystr(path))


def test_train_step_at_fixed_negatives_matches_jax():
    jopt, jstate = _ref_state()
    r = _fixed_negative_step(jopt, jstate)
    # every expert of every MoE layer is picked by some token (the case
    # where one is not is the next test's)
    assert len(r.picked) == 3 and all(
        set(ids.reshape(-1).tolist()) == set(range(CFG.n_experts))
        for ids in r.picked)
    assert all(float(g.abs().max()) > 0 for n, g in r.grads.items()
               if n.startswith("mtp.block.attn"))
    _compare_step(r)


def test_train_step_where_an_expert_goes_unpicked():
    """Expert 0 of every MoE layer picked by no token (its router bias at
    -10, below any sigmoid score's reach).  The reference's aux is
    constant, so in both packages that expert's router column gets a
    gradient that is 0 but for rounding: below 1e-6 x the router's max,
    and every gradient agrees within 1e-5 x max.  Adafactor's g /
    sqrt(v) turns that rounding into a full-size step in each package, in
    directions that need not agree: the column's update RMS is at least
    half the other columns' on both sides and the router stack's update
    RMS at most lr (Adafactor's clipping at RMS 1, over the stack), so
    that stack's step is not compared; every other parameter's step and
    all of Adafactor's statistics agree within 1e-5 and 2e-5 x max."""
    jopt, jstate = _ref_state()
    jp = _np_tree(jstate.params)
    bias = jp["segments"][1]["moe"]["router_bias"].copy()
    bias[:, 0] = -10.0
    jp["segments"][1]["moe"]["router_bias"] = bias
    jstate = dataclasses.replace(
        jstate, params=jax.tree_util.tree_map(jnp.asarray, jp))
    before = _router_columns(jp)
    r = _fixed_negative_step(jopt, jstate)
    assert len(r.picked) == 3 and all(
        set(ids.reshape(-1).tolist()) == set(range(1, CFG.n_experts))
        for ids in r.picked)
    lr = 1e-2
    got = _router_columns(convert.params_to_jax(r.state.params)) - before
    want = _router_columns(_np_tree(r.jparams)) - before
    grads = (_router_columns(convert.named_to_jax(r.state.params,
                                                  r.grads)),
             _router_columns(_np_tree(r.jgrads)))
    for g, u in zip(grads, (got, want)):
        assert np.abs(g[..., 0]).max() <= 1e-6 * np.abs(g).max()
        for i in range(3):
            col = np.sqrt(np.mean(u[i, :, 0] ** 2))
            rest = np.sqrt(np.mean(u[i, :, 1:] ** 2))
            assert col >= 0.5 * rest > 0, (i, col, rest)
        assert np.sqrt(np.mean(u ** 2)) <= lr * (1 + 1e-5)
    _compare_step(r, skip=("['moe']['router']",))


def test_remat_path_agrees_bitwise():
    """Each backbone layer checkpointed (``cfg.remat``) or not: the same
    rows (the mtp ones included) and gradients, bit for bit."""
    _, tp, _ = _model()
    tok = _tensor(_tokens(7, S))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(CFG, remat=remat)
        model = transformer.StackedLM(cfg, "cpu", tree=convert.params_from_jax(
            convert.params_to_jax(tp), cfg, device="cpu"))
        rows, _, aux = api.backbone_hidden(model, {"tokens": tok,
                                                   "labels": tok}, cfg)
        r = torch.from_numpy(np.random.default_rng(8).normal(
            size=rows.shape).astype(np.float32))
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(torch.sum(rows * r) + aux,
                                    list(named.values()), allow_unused=True)
        out.append((rows.detach(), {k: g for k, g in zip(named, grads)
                                    if g is not None}))
    (r0, g0), (r1, g1) = out
    assert torch.equal(r0, r1) and g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_fit_trains_with_the_mtp_rows():
    """Three ``fit`` steps (the config's sampler, clip + Adafactor, its
    microbatches): finite losses, every parameter moved, the mtp block's
    included; the batches' labels give 2 S - 2 rows an example."""
    cfg = dataclasses.replace(CFG, microbatches=2)
    data = batch_iterator_for(cfg, None, 4, 16, seed=0, device="cpu")
    batch = next(iter(batch_iterator_for(cfg, None, 4, 16, seed=0,
                                         device="cpu")))
    start = api.init_module(cfg, torch.Generator("cpu").manual_seed(0),
                            device="cpu")
    rows, labels, _ = api.backbone_hidden(start, batch, cfg)
    assert rows.shape[0] == labels.shape[0] == 4 * (2 * 16 - 2)
    res = loop.fit(cfg, None, make_optimizer("adafactor", 1e-2), data, 3,
                   log_every=0, device="cpu")
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    moved = {n: not torch.equal(a, b) for (n, a), b in zip(
        start.named_parameters(), res.state.params.parameters())}
    # the router bias only picks the top-k: no gradient moves it
    assert [n for n, m in moved.items() if not m] == [
        f"segments.1.{i}.moe.router_bias" for i in range(3)]
    like = step.abstract_train_state(cfg, None,
                                     make_optimizer("adafactor", 1e-2))
    assert [(n, p.shape) for n, p in like.params.named_parameters()] == [
        (n, p.shape) for n, p in res.state.params.named_parameters()]


def test_engine_steps_match_the_reference_engine():
    """Prefill, greedy decode over the latent caches and top-k through a
    RetrievalIndex at full beam: the greedy tokens equal the reference
    engine's; the index's top-k equals the dense top-k, its top-1 the
    greedy token."""
    jp, tp, _ = _model()
    steps, k, max_len = 4, 5, S + 6
    prompt = _tokens(9, S)
    jtok, jc = jax.jit(jengine.make_prefill_step(JCFG, CTX, max_len))(
        jp, {"tokens": jnp.asarray(prompt)})
    tok, caches = engine.make_prefill_step(CFG, None, max_len)(
        tp, {"tokens": _tensor(prompt)})
    jdec = jax.jit(jengine.make_decode_step(JCFG, CTX))
    decode = engine.make_decode_step(CFG, None)
    for i in range(steps):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        pos = np.full((B,), S + i, np.int32)
        jtok, jc = jdec(jp, jtok[:, None], jc, jnp.asarray(pos))
        tok, caches = decode(tp, tok[:, None].long(), caches, _tensor(pos))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    pos = torch.full((B,), S + steps, dtype=torch.long)
    index = retrieval.build_index(api.head_table(tp, CFG))
    assert index.num_leaves_shard > 1
    ids, logits, _ = engine.make_topk_step(CFG, None, k, index=index)(
        tp, tok[:, None].long(), caches, pos)
    dids, dlogits, _ = engine.make_topk_step(CFG, None, k)(
        tp, tok[:, None].long(), caches, pos)
    np.testing.assert_array_equal(ids.numpy(), dids.numpy())
    _close(logits.numpy(), dlogits.numpy(), 1e-5)
    nxt, _ = decode(tp, tok[:, None].long(), caches, pos)
    np.testing.assert_array_equal(ids[:, 0].numpy(), nxt.numpy())


def test_clip_and_adafactor_in_row_pieces_match_whole_matrices(
        monkeypatch):
    """clip + Adafactor with their fp32 temporaries taken a few rows (or
    elements) at a time, as the full-width head and expert stacks need,
    against the same step on whole matrices: the parameters and the
    statistics within 1e-6 (the sums' order differs, by fp32 rounding)."""
    transform = importlib.import_module("repro_torch.optim.transform")
    _, jstate = _ref_state()
    rng = np.random.default_rng(11)
    out = []
    for piece in (None, 7):
        if piece:
            monkeypatch.setattr(transform, "PIECE", piece)
        mine = _train_state(jstate)
        params = step.param_dict(mine.params)
        grads = {k: torch.from_numpy(rng.normal(size=p.shape).astype(
            np.float32)) if piece is None else out[0][2][k].clone()
            for k, p in params.items()}
        kept = {k: g.clone() for k, g in grads.items()}
        opt = make_optimizer("adafactor", 1e-2)
        _, opt_state = opt.update(grads, mine.opt_state, params)
        out.append((convert.params_to_jax(mine.params),
                    convert.train_state_to_jax(dataclasses.replace(
                        mine, opt_state=opt_state))[1], kept))
    for a, b in ((out[0][0], out[1][0]), (out[0][1], out[1][1])):
        for g, w in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
