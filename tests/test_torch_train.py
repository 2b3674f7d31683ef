"""The port's training slice — estimators, optimizers, data, the train step
and ``fit`` — against the JAX package, on the CPU.

Deterministic parts are compared on the same numpy inputs: estimator
losses and gradients at fixed negatives within rtol 1e-5 (fp32 sums in
other orders), optimizer updates within 1e-6, and one dense-estimator
train step from one carried state within 1e-5.  Sampled training is
random in both packages and is checked by its loss falling.
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
from repro.data.pipeline import batch_iterator_for as jbatch_iterator_for
from repro.data.synthetic import SyntheticRecsys as JSyntheticRecsys
from repro.optim import cosine_schedule as jcosine
from repro.optim import make_optimizer as jmake_optimizer
from repro.sharding.rules import local_ctx
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import estimators
from repro_torch.data.pipeline import batch_iterator_for
from repro_torch.data.synthetic import SyntheticRecsys
from repro_torch.models import api
from repro_torch.optim import cosine_schedule, make_optimizer
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
        upd, state = opt.update({k: torch.from_numpy(v) for k, v in
                                 g.items()}, state, mine)
        apply_updates(mine, upd)
        jupd, jstate = jupdate({k: jnp.asarray(v) for k, v in g.items()},
                               jstate, theirs)
        theirs = jax.tree_util.tree_map(lambda p, u: p + u, theirs, jupd)
        for k in params:
            np.testing.assert_allclose(mine[k].numpy(),
                                       np.asarray(theirs[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} {k}")


def test_make_optimizer_names():
    with pytest.raises(NotImplementedError, match="A17"):
        make_optimizer("adafactor", 1e-3)
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
    index = step.export_retrieval_index(res.state, cfg)
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
    data = batch_iterator_for(cfg, None, 4, 1, device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        loop.fit(cfg, None, opt, data, 1, checkpoint_dir="ckpt",
                 device="cpu")
    with pytest.raises(NotImplementedError, match="overlap"):
        step.make_train_step(dataclasses.replace(cfg, refresh_mode="overlap"),
                             None, opt)
    with pytest.raises(NotImplementedError, match="mesh"):
        step.make_train_step(cfg, types.SimpleNamespace(mesh="m"), opt)
    lstm = get_config("ptb-lstm").reduced()
    with pytest.raises(NotImplementedError, match="lstm"):
        step.init_train_state(torch.Generator(), lstm, None, opt,
                              device="cpu")
    with pytest.raises(NotImplementedError, match="lstm"):
        batch_iterator_for(lstm, None, 4, 8, device="cpu")


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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        dataclasses.replace(cfg, sampler="tree-quadratic").validate()


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
