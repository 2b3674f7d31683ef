"""Training the MoE, SSM and hybrid families in the port against the JAX
package, at ``reduced()`` sizes on the CPU, fp32: falcon-mamba-7b (4
mamba+none layers, one segment of 4), jamba-v0.1-52b (8 layers: attention
at 4, MoE at every odd layer, one-layer segments) and dbrx-132b (4
attn+moe layers, one segment).

* ``hidden_states``, the MoE aux and every parameter's gradient of
  ``sum(h * r) + 0.5 * aux`` through a ``StackedLM``, against ``jax.grad``
  of the reference's ``transformer.hidden_states`` at S = 300 (the scan's
  chunk is 256, so the last chunk is ragged; at capacity factor 1.25
  assignments drop): within 1e-4 x max|ref| (fp32 through up to 8 layers,
  the whole-model tolerance of ``test_torch_dense_train.py``).
* The remat paths (``cfg.remat``: each layer checkpointed; the scan's
  chunks always are under autograd) against the plain one: hidden states,
  aux and gradients bitwise equal.
* A dropped MoE assignment gets no gradient: its combine weight's and,
  where all of a token's assignments drop, the token's are exactly 0.
* One train step at fixed shared negatives ``(h, labels, neg_ids,
  logq)`` with the step's ``aux_coef`` of 0.01: the loss within 1e-5
  relative, the parameters after clip + Adafactor within 1e-5 (rtol and
  atol), Adafactor's statistics within 2e-5 x max|ref| (means of squared
  gradients: a square's relative error is twice its gradient's).
* ``fit`` on each family through ``batch_iterator_for``'s SyntheticLM
  chain with Adafactor.

Weights come from the reference's ``init_params`` (norm scales, biases,
mamba's ``d`` and ``conv_b`` perturbed away from their constant inits);
tokens and the other inputs from numpy seeds.  The JAX side runs under
``jax.jit``.
"""
import dataclasses
import functools

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
from repro.sharding.rules import local_ctx
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import estimators
from repro_torch.data.pipeline import batch_iterator_for
from repro_torch.models import api, moe, transformer
from repro_torch.optim import make_optimizer
from repro_torch.optim.transform import apply_updates
from repro_torch.train import loop, step

torch.set_num_threads(1)

CTX = local_ctx()
ARCHS = ("falcon-mamba-7b", "jamba-v0.1-52b", "dbrx-132b")
B, S_LONG, S_STEP = 2, 300, 12
AUX_W = 0.5
MODEL_TOL = 1e-4
STEP_TOL = 1e-5
STATS_TOL = 2 * STEP_TOL
#: the train step's weight of the MoE aux (``make_train_step``'s default)
AUX_COEF = 0.01


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol, msg=""):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, msg
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{msg}: max |got - want| {err} > {bound}"


def _perturbed(np_params, seed):
    """Norm scales and biases, mamba's ``d`` and ``conv_b`` moved off
    their constant inits (1 and 0)."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if name in ("bias", "conv_b"):
            return (rng.normal(size=node.shape) * 0.1).astype(node.dtype)
        if name in ("scale", "d"):
            return (1.0 + rng.normal(size=node.shape) * 0.1
                    ).astype(node.dtype)
        return node
    return walk(np_params)


@functools.lru_cache(maxsize=None)
def _weights(arch: str):
    jcfg = jget_config(arch).reduced()
    jp = jax.jit(lambda k: japi.init_params(k, jcfg, CTX))(
        jax.random.PRNGKey(0))
    return _perturbed(_np_tree(jp), 1)


def _module(arch: str, **over) -> tuple:
    cfg = get_config(arch).reduced(**over)
    return cfg, transformer.StackedLM(cfg, "cpu", tree=convert.params_from_jax(
        _weights(arch), cfg, device="cpu"))


def _port_grads(model, cfg, tokens, r):
    h, aux = transformer.hidden_states(model, torch.from_numpy(tokens), cfg)
    named = dict(model.named_parameters())
    loss = torch.sum(h * torch.from_numpy(r)) + AUX_W * aux
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    return h.detach(), aux.detach(), {
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(named.items(), grads)}


@pytest.mark.parametrize("arch", ARCHS)
def test_hidden_states_aux_and_param_grads_match_jax(arch):
    jcfg = jget_config(arch).reduced()
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (B, S_LONG)).astype(np.int32)
    r = _normal(3, (B, S_LONG, jcfg.d_model))

    def jloss(params):
        h, aux = jtf.hidden_states(params, tokens, jcfg, CTX)
        return jnp.sum(h * r) + AUX_W * aux, (h, aux)
    (_, (jh, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                     _weights(arch)))
    cfg, model = _module(arch)
    h, aux, grads = _port_grads(model, cfg, tokens, r)
    _close(h.numpy(), jh, MODEL_TOL, f"{arch} h")
    if cfg.n_experts:
        assert float(jaux) > 0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    else:
        assert float(aux) == float(jaux) == 0.0
    got = convert.named_to_jax(model, grads)
    want = _np_tree(jgrads)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        _close(g, w, MODEL_TOL, f"{arch} grad {jax.tree_util.keystr(path)}")
    if cfg.n_experts:  # the router learns through the aux's mean probs
        router = [g for (path, g) in flat_g
                  if "router" in jax.tree_util.keystr(path)]
        assert router and all(np.abs(g).max() > 0 for g in router)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_paths_agree_bitwise(arch):
    """Each layer checkpointed (``cfg.remat``) or not: the same hidden
    states, aux and gradients, bit for bit."""
    tokens = np.random.default_rng(4).integers(
        0, 512, (B, S_LONG)).astype(np.int32)
    r = _normal(5, (B, S_LONG, 64))
    out = []
    for remat in (False, True):
        cfg, model = _module(arch, remat=remat)
        out.append(_port_grads(model, cfg, tokens, r))
    (h0, a0, g0), (h1, a1, g1) = out
    assert torch.equal(h0, h1) and torch.equal(a0, a1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_dropped_moe_assignments_get_no_gradient():
    """At a capacity of 2 slots for 16 tokens on 4 experts (top-2), most
    assignments drop: their combine weights' gradients are 0, and so is a
    token's gradient through the dispatch when all of its assignments
    drop."""
    cfg = get_config("dbrx-132b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg, torch.device("cpu"))
    x2d = torch.randn((16, cfg.d_model), generator=gen, requires_grad=True)
    ids, w, _ = moe._route(p, x2d.detach(), cfg)
    w = w.detach().requires_grad_(True)
    cap = 2
    y = moe._dispatch_compute_combine(x2d, ids, w, p["w_gate"], p["w_up"],
                                      p["w_down"], cfg, cap)
    gx, gw = torch.autograd.grad(torch.sum(y * torch.randn(
        y.shape, generator=gen)), (x2d, w))
    _, keep = moe._slots(ids, cfg.n_experts, cap)
    assert int((~keep).sum()) > 0 and bool((gw[~keep] == 0).all())
    assert bool((gw[keep] != 0).all())
    gone = ~keep.any(dim=1)
    assert int(gone.sum()) > 0 and bool((gx[gone] == 0).all())
    assert bool((gx[~gone].abs().sum(dim=1) > 0).all())


# --- one train step at fixed negatives, then clip + Adafactor ----------------


@functools.lru_cache(maxsize=None)
def _ref_state(arch: str):
    jcfg = jget_config(arch).reduced()
    jopt = jmake_optimizer("adafactor", 1e-2)
    state = jax.jit(lambda key: jstep.init_train_state(key, jcfg, CTX, jopt,
                                                       max_len=8))(
        jax.random.PRNGKey(0))
    params = _perturbed(_np_tree(state.params), 4)
    return jcfg, jopt, dataclasses.replace(
        state, params=jax.tree_util.tree_map(jnp.asarray, params))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_at_fixed_negatives_matches_jax(arch):
    jcfg, jopt, jstate = _ref_state(arch)
    cfg = get_config(arch).reduced()
    opt = make_optimizer("adafactor", 1e-2)
    mine = convert.train_state_from_jax(
        _np_tree(jstate.params), _np_tree(jstate.opt_state),
        {"stats": _np_tree(jstate.sampler_state.stats),
         "const": _np_tree(jstate.sampler_state.const)}, 0, cfg,
        device="cpu")
    assert isinstance(mine.params, transformer.StackedLM)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, S_STEP)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S_STEP)).astype(np.int32)
    batch_np = {"tokens": tokens, "labels": labels}
    m = cfg.m_negatives
    neg = rng.choice(cfg.vocab_size, m, replace=False).astype(np.int32)
    logq = np.log(rng.uniform(1e-4, 1e-2, m)).astype(np.float32)

    def jloss(params):
        hh, lab, aux = japi.backbone_hidden(params, batch_np, jcfg, CTX)
        loss = jnp.mean(jest.loss_from_embeddings(
            jest.make_estimator(jcfg.estimator),
            japi.head_table(params, jcfg), hh, lab, neg, logq,
            abs_mode=jcfg.abs_softmax))
        return loss + AUX_COEF * aux

    @jax.jit
    def jstep_fn(params, opt_state):
        loss, grads = jax.value_and_grad(jloss)(params)
        upd, opt_state = jopt.update(grads, opt_state, params)
        return loss, japply_updates(params, upd), opt_state
    jl, jparams, jopt_state = jstep_fn(jstate.params, jstate.opt_state)

    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in batch_np.items()}
    hh, lab, aux = api.backbone_hidden(mine.params, batch, cfg)
    loss = torch.mean(estimators.loss_from_embeddings(
        estimators.make_estimator(cfg.estimator),
        api.head_table(mine.params, cfg), hh, lab,
        torch.from_numpy(neg.astype(np.int64)), torch.from_numpy(logq),
        abs_mode=cfg.abs_softmax, impl=cfg.head_impl)) + AUX_COEF * aux
    params = step.param_dict(mine.params)
    grads = torch.autograd.grad(loss, list(params.values()))
    _close(loss.item(), float(jl), STEP_TOL, "loss")
    upd, opt_state = opt.update(dict(zip(params, grads)), mine.opt_state,
                                params)
    apply_updates(params, upd)
    got = convert.params_to_jax(mine.params)
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(_np_tree(jparams))[0]):
        np.testing.assert_allclose(g, w, rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    _, back, _, _ = convert.train_state_to_jax(dataclasses.replace(
        mine, opt_state=opt_state))
    for (path, g), (p2, w) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(_np_tree(jopt_state))[0]):
        assert path == p2
        _close(g, w, STATS_TOL, jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_fit_trains_each_family_with_adafactor(arch):
    """Three ``fit`` steps on the SyntheticLM chain (the config's default
    sampler, clip + Adafactor): finite losses, the parameters moved."""
    cfg = get_config(arch).reduced()
    data = batch_iterator_for(cfg, None, 2, 16, seed=0, device="cpu")
    res = loop.fit(cfg, None, make_optimizer("adafactor", 1e-2), data, 3,
                   log_every=0, device="cpu")
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    start = api.init_module(cfg, torch.Generator("cpu").manual_seed(0),
                            device="cpu")
    moved = [not torch.equal(a, b) for a, b in zip(
        start.parameters(), res.state.params.parameters())]
    assert sum(moved) == len(moved)
