"""The port's training slice — estimators, optimizers, data, the train step
and ``fit`` — against the JAX package, on the CPU.

Deterministic parts are compared on the same numpy inputs: estimator
losses and gradients at fixed negatives within rtol 1e-5 (fp32 sums in
other orders), optimizer updates within 1e-6, one dense-estimator train
step from one carried state within 1e-5, and for each hierarchical sampler
family (tree-quadratic, rff, midx) the refresh, the logq of given draws and
the sampled loss and gradients at those draws, from one carried state,
within 1e-5.  Sampled training is random in both packages and is checked by
its loss falling.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import estimators as jest
from repro.core import samplers as jsamplers
from repro.core import tree as jtree
from repro.data.pipeline import batch_iterator_for as jbatch_iterator_for
from repro.data.synthetic import SyntheticRecsys as JSyntheticRecsys
from repro.models import api as japi
from repro.optim import cosine_schedule as jcosine
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim.clip import clip_by_global_norm as jclip_by_global_norm
from repro.sharding.rules import local_ctx
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import estimators, samplers
from repro_torch.data.pipeline import batch_iterator_for
from repro_torch.data.synthetic import SyntheticRecsys
from repro_torch.models import api
from repro_torch.optim import (clip_by_global_norm, cosine_schedule,
                               make_optimizer)
from repro_torch.optim.transform import apply_updates
from repro_torch.serve import retrieval
from repro_torch.train import loop, step

torch.set_num_threads(1)

CTX = local_ctx()


def _t(x):
    """numpy -> torch, int32 ids to the port's int64."""
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype == np.int32
                            else x.copy())


def _head_inputs(seed=0, n=40, d=8, t=7, m=9):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(n, d)) * 0.5).astype(np.float32)
    h = (rng.normal(size=(t, d)) * 0.5).astype(np.float32)
    labels = rng.integers(0, n, (t,)).astype(np.int32)
    neg = rng.integers(0, n, (t, m)).astype(np.int32)
    neg[:2, 1] = labels[:2]  # accidental hits
    logq = np.log(rng.uniform(0.01, 0.1, (t, m))).astype(np.float32)
    bias = (rng.normal(size=(n,)) * 0.2).astype(np.float32)
    return w, h, labels, neg, logq, bias


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("abs_mode", [False, True])
@pytest.mark.parametrize("name", ["sampled-softmax", "nce",
                                  "sampled-logistic", "full"])
def test_estimators_match_reference_at_fixed_negatives(name, abs_mode,
                                                       with_bias):
    """Loss and dL/d(w, h, bias) of every estimator through
    ``loss_from_embeddings`` (the fused head's plain path for the
    default)."""
    w, h, labels, neg, logq, bias = _head_inputs(seed=len(name))

    def jloss(w_, h_, b_):
        return jnp.sum(jest.loss_from_embeddings(
            jest.make_estimator(name), w_, h_, labels, neg, logq,
            abs_mode=abs_mode, bias=b_ if with_bias else None))
    jl, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        w, h, bias)
    tw, th, tb = (torch.from_numpy(x).requires_grad_() for x in (w, h, bias))
    loss = torch.sum(estimators.loss_from_embeddings(
        estimators.make_estimator(name), tw, th, _t(labels), _t(neg),
        _t(logq), abs_mode=abs_mode, bias=tb if with_bias else None))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgrads[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgrads[1]),
                               rtol=1e-5, atol=1e-6)
    if with_bias:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgrads[2]),
                                   rtol=1e-5, atol=1e-6)
    assert estimators.estimator_names() == jest.estimator_names()


def test_estimator_contract_errors():
    w, h, labels, *_ = (_t(x) for x in _head_inputs())
    with pytest.raises(ValueError, match="needs sampled negatives"):
        estimators.loss_from_embeddings(
            estimators.make_estimator("nce"), w, h, labels, None, None)
    with pytest.raises(TypeError, match="dense"):
        estimators.make_estimator("full").loss(None, None, None, None)
    with pytest.raises(KeyError):
        estimators.make_estimator("softmax")


OPTIMIZERS = {
    "adamw": (lambda: make_optimizer("adamw", 1e-2),
              lambda: jmake_optimizer("adamw", 1e-2)),
    "adamw-cosine": (
        lambda: make_optimizer("adamw", cosine_schedule(3e-2, 2, 5),
                               weight_decay=0.0),
        lambda: jmake_optimizer("adamw", jcosine(3e-2, 2, 5),
                                weight_decay=0.0)),
    "sgd-momentum": (lambda: make_optimizer("sgd", 0.1, momentum=0.9),
                     lambda: jmake_optimizer("sgd", 0.1, momentum=0.9)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_five_clipped_updates_match_reference(name):
    """Five ``chain(clip_by_global_norm(1.0), opt)`` updates on identical
    gradients (norms above and below the clip) give the same parameters."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (3.0, 0.1, 2.0, 0.05, 1)]
    mk, jmk = OPTIMIZERS[name]
    opt, jopt = mk(), jmk()
    mine = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    theirs = {k: jnp.asarray(v) for k, v in params.items()}
    state, jstate = opt.init(mine), jopt.init(theirs)
    jupdate = jax.jit(jopt.update)
    for g in grads:
        # the port's clip scales its input in place: hand it copies, so
        # that the reference gets the gradients unclipped
        upd, state = opt.update({k: torch.from_numpy(v.copy()) for k, v in
                                 g.items()}, state, mine)
        apply_updates(mine, upd)
        jupd, jstate = jupdate({k: jnp.asarray(v) for k, v in g.items()},
                               jstate, theirs)
        theirs = jax.tree_util.tree_map(lambda p, u: p + u, theirs, jupd)
        for k in params:
            np.testing.assert_allclose(mine[k].numpy(),
                                       np.asarray(theirs[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", [3.0, 0.1])
def test_clip_scales_its_input_in_place_as_the_reference_clips(dtype, norm):
    """``clip_by_global_norm(1.0).update`` on gradients of global norm
    above and below 1: the port scales the very tensors it is given and
    returns them; the reference, on its own copy, gives the same values
    (1e-6 relative in fp32; in bf16 within one rounding, 2^-7)."""
    rng = np.random.default_rng(1)
    g = {"a": rng.normal(size=(40, 30)), "b": rng.normal(size=(7,))}
    total = np.sqrt(sum(np.sum(v ** 2) for v in g.values()))
    g = {k: (v * norm / total).astype(np.float32) for k, v in g.items()}
    mine = {k: torch.from_numpy(v.copy()).to(getattr(torch, dtype))
            for k, v in g.items()}
    given = {k: (v, v.data_ptr(), v.clone()) for k, v in mine.items()}
    out, _ = clip_by_global_norm(1.0).update(mine, (), None)
    want, _ = jclip_by_global_norm(1.0).update(
        {k: jnp.asarray(v).astype(dtype) for k, v in g.items()}, (), None)
    assert out is mine
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for k, (t, ptr, before) in given.items():
        assert out[k] is t and t.data_ptr() == ptr
        assert torch.equal(t, before) == (norm <= 1.0), k
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   rtol=rtol, atol=0, err_msg=k)
    got_norm = float(torch.sqrt(sum(torch.sum(v.float() ** 2)
                                    for v in out.values())))
    np.testing.assert_allclose(got_norm, min(norm, 1.0), rtol=1e-2)


def test_make_optimizer_names():
    opt = make_optimizer("adafactor", 1e-3)
    state = opt.init({"w": torch.zeros(3, 2)})
    assert set(state[1]) == {"v", "step"}
    with pytest.raises(KeyError):
        make_optimizer("lamb", 1e-3)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carried(jstate_, cfg):
    """A reference TrainState as the port's, through the converter."""
    ss = jstate_.sampler_state
    return convert.train_state_from_jax(
        _np_tree(jstate_.params), _np_tree(jstate_.opt_state),
        {"stats": _np_tree(ss.stats), "const": _np_tree(ss.const)},
        int(jstate_.step), cfg, device="cpu")


def _batches(jcfg, n, batch=16):
    data = jbatch_iterator_for(jcfg, CTX, global_batch=batch, seq_len=1,
                               seed=3)
    return [_np_tree(next(data)) for _ in range(n)]


def test_dense_step_from_a_carried_state_matches_reference():
    """Two reference steps with estimator='full' (deterministic end to
    end), the state carried into the port, then one more step in both:
    the same loss and the same updated parameters within 1e-5."""
    jcfg = jget_config("youtube-dnn").reduced(estimator="full")
    cfg = get_config("youtube-dnn").reduced(estimator="full")
    jopt = jmake_optimizer("adamw", 1e-2)
    state_j = jstep.init_train_state(jax.random.PRNGKey(0), jcfg, CTX, jopt)
    jfn = jax.jit(jstep.make_train_step(jcfg, CTX, jopt))
    b0, b1, b2 = _batches(jcfg, 3)
    for b in (b0, b1):
        state_j, _ = jfn(state_j, b, jax.random.PRNGKey(1))
    mine = _carried(state_j, cfg)
    assert mine.step == 2 and int(mine.opt_state[1]["step"]) == 2
    state_j, jmetrics = jfn(state_j, b2, jax.random.PRNGKey(1))
    fn = step.make_train_step(cfg, None, make_optimizer("adamw", 1e-2))
    mine, metrics = fn(mine, {k: _t(v) for k, v in b2.items()},
                       torch.Generator())
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    want = convert.params_from_jax(_np_tree(state_j.params), cfg,
                                   device="cpu")
    for name, p in mine.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   getattr(want, name).detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert mine.step == 3


def test_block_sampler_state_is_carried_and_refreshed_like_reference():
    """A block-quadratic reference state carries its z / cnt / wq across,
    and the port's refresh rebuilds the reference's statistics from the
    same head."""
    jcfg = jget_config("youtube-dnn").reduced()
    cfg = get_config("youtube-dnn").reduced()
    jopt = jmake_optimizer("adamw", 1e-2)
    state_j = jstep.init_train_state(jax.random.PRNGKey(0), jcfg, CTX, jopt)
    mine = _carried(state_j, cfg)
    for k, v in state_j.sampler_state.stats.items():
        np.testing.assert_array_equal(mine.sampler_state.stats[k].numpy(),
                                      np.asarray(v))
    jref = jstep.make_refresh_fn(jcfg, CTX)
    want = jref(state_j.params["head"]["w"], state_j.sampler_state)
    refresh = step.make_refresh_fn(cfg, None)
    assert refresh.carries_stats
    got = refresh(api.head_table(mine.params, cfg), mine.sampler_state)
    for k in ("z", "cnt", "wq"):
        np.testing.assert_allclose(got.stats[k].numpy(),
                                   np.asarray(want.stats[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


HIER = ["tree-quadratic", "rff", "midx"]


def _close_stats(got: dict, want: dict, rtol=1e-5, atol=1e-6):
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        if v.dtype.kind == "i":
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), v, rtol=rtol,
                                       atol=atol, err_msg=k)


def _jall_class_logq(jsmp, runtime, h):
    if isinstance(jsmp, jsamplers.TreeSampler):
        return jtree.all_class_logq(runtime["stats"], jsmp.kernel, h,
                                    runtime["proj"])
    return jsmp.all_class_logq(runtime, h)


@pytest.mark.parametrize("family", HIER)
def test_hierarchical_step_from_a_carried_state_matches_reference(family):
    """A reference state (params, AdamW state, the family's carried
    statistics and constants) carried into the port: its statistics arrive
    unchanged, the port's refresh rebuilds the reference's from the same
    head, the port's draws report the reference's exact logq at their ids,
    and the sampled loss and every gradient at those draws agree."""
    jcfg = jget_config("youtube-dnn").reduced(sampler=family)
    cfg = get_config("youtube-dnn").reduced(sampler=family)
    jopt = jmake_optimizer("adamw", 1e-2)
    state_j = jax.jit(lambda k: jstep.init_train_state(k, jcfg, CTX, jopt))(
        jax.random.PRNGKey(0))
    mine = _carried(state_j, cfg)
    ss = state_j.sampler_state
    _close_stats(mine.sampler_state.stats, ss.stats, rtol=0, atol=0)
    _close_stats(mine.sampler_state.const, ss.const, rtol=0, atol=0)

    head_j = japi.head_table(state_j.params, jcfg)
    want = jax.jit(jstep.make_refresh_fn(jcfg, CTX))(head_j, ss)
    head = api.head_table(mine.params, cfg)
    got = step.make_refresh_fn(cfg, None)(head, mine.sampler_state)
    _close_stats(got.stats, want.stats)

    batch_np = _batches(jcfg, 1)[0]
    batch = {k: _t(v) for k, v in batch_np.items()}
    smp, jsmp = (samplers.sampler_from_config(cfg),
                 jsamplers.sampler_from_config(jcfg))
    runtime = smp.hydrate(got, cfg.vocab_size)
    jruntime = jsmp.hydrate(want, cfg.vocab_size)
    with torch.no_grad():
        h, labels, _ = api.backbone_hidden(mine.params, batch, cfg)
        neg, logq = smp.sample_batch(runtime, h, cfg.m_negatives,
                                     torch.Generator().manual_seed(3))
    jh, _, _ = japi.backbone_hidden(state_j.params, batch_np, jcfg, CTX)
    joracle = jax.jit(lambda r, h_: _jall_class_logq(jsmp, r, h_))
    jlogq = np.stack([np.asarray(joracle(jruntime, jh[t]))[neg[t].numpy()]
                      for t in range(h.shape[0])])
    np.testing.assert_allclose(logq.numpy(), jlogq, rtol=1e-5, atol=1e-5)

    est = estimators.make_estimator(cfg.estimator)
    jneg = neg.numpy().astype(np.int32)

    def jloss(params):
        hh, lab, _ = japi.backbone_hidden(params, batch_np, jcfg, CTX)
        return jnp.mean(jest.loss_from_embeddings(
            jest.make_estimator(jcfg.estimator),
            japi.head_table(params, jcfg), hh, lab, jneg, jlogq,
            abs_mode=jcfg.abs_softmax))
    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(state_j.params)
    hh, lab, _ = api.backbone_hidden(mine.params, batch, cfg)
    loss = torch.mean(estimators.loss_from_embeddings(
        est, api.head_table(mine.params, cfg), hh, lab, neg, logq,
        abs_mode=cfg.abs_softmax))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want_g = convert.params_from_jax(_np_tree(jgrads), cfg, device="cpu")
    for name, p in mine.params.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   getattr(want_g, name).detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("family", HIER)
def test_reduced_youtube_dnn_trains_with_hierarchical_samplers(family):
    """30 steps of ``fit`` with the family's sync refresh every step on the
    CPU (the kernels' plain versions): the loss falls."""
    cfg = get_config("youtube-dnn").reduced(sampler=family)
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    data = batch_iterator_for(cfg, None, 128, 1, seed=0, device="cpu")
    res = loop.fit(cfg, None, opt, data, 30, log_every=0, device="cpu")
    losses = np.asarray(res.losses)
    assert losses.shape == (30,) and np.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean()
    assert res.state.step == 30
    shapes = samplers.sampler_from_config(cfg).state_shapes(cfg)
    assert {k: tuple(v.shape) for k, v in shapes.stats.items()} == \
        {k: tuple(v.shape) for k, v in res.state.sampler_state.stats.items()}


def test_microbatched_step_equals_one_batch():
    """microbatches=2 averages the two halves' gradients: with the dense
    estimator (no sampling) one step equals the unsplit step."""
    cfg = get_config("youtube-dnn").reduced(estimator="full")
    jcfg = jget_config("youtube-dnn").reduced(estimator="full")
    batch = {k: _t(v) for k, v in _batches(jcfg, 1)[0].items()}
    states = []
    for mu in (1, 2):
        c = dataclasses.replace(cfg, microbatches=mu)
        opt = make_optimizer("sgd", 0.5)
        st = step.init_train_state(torch.Generator().manual_seed(0), c,
                                   None, opt, device="cpu")
        st, metrics = step.make_train_step(c, None, opt)(
            st, batch, torch.Generator())
        states.append((st, float(metrics["loss"])))
    (a, la), (b, lb) = states
    np.testing.assert_allclose(la, lb, rtol=1e-5)
    for (name, p), q in zip(a.params.named_parameters(),
                            b.params.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_reduced_youtube_dnn_trains_with_block_quadratic():
    """30 steps of the full training path (sync refresh every step,
    block-quadratic sampling, eq. 2/3 loss through the fused head's plain
    path, clip + AdamW) on the CPU: the loss falls; the trained head exports
    a retrieval index whose full beam equals the dense top-k."""
    cfg = get_config("youtube-dnn").reduced()
    assert (cfg.sampler, cfg.abs_softmax, cfg.sampler_refresh_every) == \
        ("block-quadratic", True, 1)
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    data = batch_iterator_for(cfg, None, 128, 1, seed=0, device="cpu")
    res = loop.fit(cfg, None, opt, data, 30, log_every=0, device="cpu")
    losses = np.asarray(res.losses)
    assert losses.shape == (30,) and np.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean()
    assert res.state.step == 30 and res.refresh_staleness == [0] * 30
    index = step.export_retrieval_index(res.state, cfg, None)
    head = api.head_table(res.state.params, cfg).detach()
    h = torch.randn((4, head.shape[1]), generator=torch.Generator()
                    .manual_seed(0))
    ids, logits = retrieval.decode_topk(index, h, 5)
    dids, dlogits = retrieval.dense_topk(head, h, 5, n_valid=cfg.vocab_size)
    np.testing.assert_array_equal(ids.numpy(), dids.numpy())
    np.testing.assert_allclose(logits.numpy(), dlogits.numpy(), rtol=1e-5)


def test_fit_flags_an_injected_straggler():
    cfg = get_config("youtube-dnn").reduced(estimator="full")
    data = batch_iterator_for(cfg, None, 16, 1, seed=0, device="cpu")
    res = loop.fit(cfg, None, make_optimizer("sgd", 0.1), data, 8,
                   log_every=0, slow_step_injection={6: 1.0},
                   device="cpu")
    assert 6 in res.straggler_steps and len(res.losses) == 8
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        loop.fit(cfg, None, make_optimizer("sgd", 0.1), data, 8,
                 fail_at_step=2, log_every=0, device="cpu")


def test_unported_training_options_raise():
    cfg = get_config("youtube-dnn").reduced()
    opt = make_optimizer("adamw", 1e-2)
    with pytest.raises(NotImplementedError, match="A17"):
        step.export_quantized_index(
            step.init_train_state(torch.Generator().manual_seed(0), cfg,
                                  None, opt, device="cpu"), cfg,
            types.SimpleNamespace(mesh="m"))
    with pytest.raises(NotImplementedError, match="mesh"):
        step.make_train_step(cfg, types.SimpleNamespace(mesh="m"), opt)
    # the encoder-decoder family trains now: its state and its batches
    encdec = get_config("whisper-large-v3").reduced()
    state = step.init_train_state(torch.Generator(), encdec, None, opt,
                                  max_len=8, device="cpu")
    assert type(state.params).__name__ == "EncDec"
    assert state.params.dec_pos.table.shape == (8, encdec.d_model)
    batch = next(batch_iterator_for(encdec, None, 4, 8, device="cpu"))
    assert batch["frames"].shape == (4, 8, encdec.d_model)
    other = dataclasses.replace(encdec, family="vision")
    with pytest.raises(NotImplementedError, match="vision"):
        batch_iterator_for(other, None, 4, 8, device="cpu")


def test_validate_checks_ported_names_and_knobs():
    cfg = get_config("youtube-dnn")
    assert cfg.validate() is cfg
    jget_config("youtube-dnn").validate()
    for bad, match in ((dict(sampler="block-quadratc"), "unknown sampler"),
                       (dict(estimator="sofmax"), "unknown estimator"),
                       (dict(head_impl="triton"), "unknown head_impl"),
                       (dict(m_negatives=0), "m_negatives"),
                       (dict(sampler_refresh_every=0), "refresh_every"),
                       (dict(microbatches=0), "microbatches"),
                       (dict(refresh_mode="async"), "refresh_mode")):
        with pytest.raises(ValueError, match=match):
            dataclasses.replace(cfg, **bad).validate()
    for ported in ("tree-quadratic", "rff", "midx", "midx-oracle", "tapas",
                   "softmax", "rff-oracle"):
        assert dataclasses.replace(cfg, sampler=ported).validate()
    with pytest.raises(ValueError, match="cannot drive the head loss"):
        dataclasses.replace(cfg, sampler="unigram").validate()
    for bad, match in ((dict(sampler="tapas", tapas_pool=0), "tapas"),
                       (dict(sampler="tapas", tapas_tau=0.0), "tapas"),
                       (dict(sampler="tapas", tapas_base="tapas"), "nest"),
                       (dict(sampler="rff", rff_dim=0), "rff_dim"),
                       (dict(sampler="rff", rff_tau=0.0), "rff_tau"),
                       (dict(sampler="midx", midx_codewords=0),
                        "midx_codewords"),
                       (dict(sampler="midx", midx_codebooks=3),
                        "midx_codebooks"),
                       (dict(sampler="midx", sampler_proj_rank=16),
                        "sampler_proj_rank")):
        with pytest.raises(ValueError, match=match):
            dataclasses.replace(cfg, **bad).validate()


def test_synthetic_recsys_batches_and_resumable_iterator():
    cfg = get_config("youtube-dnn").reduced()
    data = batch_iterator_for(cfg, None, 8, 1, seed=5, device="cpu")
    first = [next(data) for _ in range(3)]
    b = first[0]
    assert b["history"].shape == (8, cfg.history_len)
    assert b["user_feats"].shape == (8, cfg.user_feature_dim)
    assert b["labels"].shape == (8,) and b["labels"].dtype == torch.int64
    assert 0 <= int(b["labels"].min()) and \
        int(b["labels"].max()) < cfg.vocab_size
    saved = data.state_dict()
    nxt = next(data)
    again = batch_iterator_for(cfg, None, 8, 1, seed=5, device="cpu")
    again.load_state(saved)
    resumed = next(again)
    for k in nxt:
        assert torch.equal(nxt[k], resumed[k])
    fresh = batch_iterator_for(cfg, None, 8, 1, seed=5, device="cpu")
    assert torch.equal(next(fresh)["labels"], first[0]["labels"])
    # same task in distribution: the Bayes loss floors agree
    mine = SyntheticRecsys(n_items=512, device="cpu").bayes_loss(2048)
    theirs = JSyntheticRecsys(n_items=512).bayes_loss(2048)
    assert abs(mine - theirs) < 0.05 * theirs
