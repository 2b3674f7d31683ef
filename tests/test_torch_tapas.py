"""The port's two-pass tapas sampler against the JAX package, on the CPU.

Deterministic parts are compared on the same numpy inputs:
``pool_log_inclusion`` near q -> 0 and q -> 1 within rtol 1e-5, and at a
given pool (the reference's own draw) the re-scored logits and the per-slot
categorical ``s`` within 1e-5 and the composed logq of every slot within
1e-4.  Draws come from ``torch.Generator``s: stage 2 on a fixed pool and
the whole two-pass scheme over 300 real pools are held to the brute-force
conditional oracle by the chi-square/TV gate of
``tests/test_sampler_stats.py``; the eq. 2 partition estimate is unbiased
and, at tau = 1, the corrected logit is constant along each row.  Then the
corners of the reference's ``tests/test_tapas.py``, the facade, the train
step (the runtime ``{"base", "w", "n_valid"}``) and three ``fit`` steps.
The reference's ``test_local_train_steps`` (a falling loss over three
steps of fresh random labels) fails on the reference itself and is not
copied."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import samplers as jsamplers
from repro_torch.api import SoftmaxHead
from repro_torch.configs import get_config
from repro_torch.core import estimators, samplers
from repro_torch.core.samplers import TapasSampler, pool_log_inclusion
from repro_torch.data.pipeline import batch_iterator_for
from repro_torch.optim import make_optimizer
from repro_torch.train import loop
from test_sampler_stats import _check_against, _check_counts

torch.set_num_threads(1)

N, D, T, POOL = 64, 12, 2, 48
BASES = ["uniform", "block-quadratic-shared"]
EST_NAMES = ("sampled-softmax", "nce", "sampled-logistic")


def _inputs(seed=0, n=N, t=T):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n, D)) * 0.5).astype(np.float32),
            rng.normal(size=(t, D)).astype(np.float32))


def _mine(base_name, w, pool=POOL, tau=1.0):
    kwargs = {"block_size": 16} if base_name.startswith("block") else {}
    smp = TapasSampler(base=samplers.make_sampler(base_name, **kwargs),
                       pool=pool, tau=tau)
    tw = torch.from_numpy(w)
    state = smp.init_state(torch.Generator().manual_seed(0), tw)
    return smp, smp.island_runtime(state, tw, w.shape[0])


def _dense_conditional(smp, w, pool_ids, logq1, h):
    """Brute-force dense oracle for one realized pool, in fp64 numpy:
    the per-class conditional q2(. | pool) (T, n) and the composed per-class
    log q (T, n)."""
    logpi = np.asarray(jsamplers.pool_log_inclusion(
        jnp.asarray(logq1), smp.pool), np.float64)
    pool_np = np.asarray(pool_ids)
    mult = (pool_np[None, :] == pool_np[:, None]).sum(0)
    o = (h.astype(np.float64) @ w.astype(np.float64)[pool_np].T) / smp.tau
    s = o - (logpi + np.log(mult))[None, :]
    lz = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    q2 = np.zeros((h.shape[0], w.shape[0]))
    composed = np.full((h.shape[0], w.shape[0]), -np.inf)
    for t in range(h.shape[0]):
        np.add.at(q2[t], pool_np, np.exp(s[t] - lz[t]))
        composed[t, pool_np] = o[t] - lz[t]
    return q2, composed, s


def test_pool_log_inclusion_matches_reference_at_both_ends():
    logq1 = np.concatenate([np.log(np.array([1e-12, 1e-9, 1e-6, 1e-3]))
                            , np.log1p(-np.array([1e-3, 1e-6, 1e-7])),
                            [0.0]]).astype(np.float32)
    for pool in (1, 48, 1024):
        got = pool_log_inclusion(torch.from_numpy(logq1), pool).numpy()
        want = np.asarray(jsamplers.pool_log_inclusion(jnp.asarray(logq1),
                                                       pool))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # q1 -> 0: log(P q1) without cancellation; q1 -> 1: 0
    small = pool_log_inclusion(torch.tensor([np.log(1e-12)]), 1024)
    np.testing.assert_allclose(small.numpy(), np.log(1024e-12), rtol=1e-5)
    assert float(pool_log_inclusion(torch.tensor([0.0]), 4)) == 0.0


@pytest.mark.parametrize("base_name", BASES)
def test_slot_logits_and_composed_logq_at_a_given_pool(base_name):
    """At the reference's own pool draw: the port's re-scored logits and
    per-slot categorical s, and the composed logq of every slot, against
    the dense recomputation; the port's resample reports it at its draws,
    which follow q2(. | pool)."""
    w, h = _inputs(seed=1)
    jkw = {"block_size": 16} if base_name.startswith("block") else {}
    jsmp = jsamplers.make_sampler("tapas", base=jsamplers.make_sampler(
        base_name, **jkw), pool=POOL)
    jst = jsmp.init(jax.random.PRNGKey(2), jnp.asarray(w))
    pool_ids, logq1 = jsmp.draw_pool(jst, jnp.asarray(h),
                                     jax.random.PRNGKey(3))
    smp, rt = _mine(base_name, w)
    tpool = torch.from_numpy(np.asarray(pool_ids).astype(np.int64))
    tlogq1 = torch.from_numpy(np.array(logq1))
    q2, composed, s_want = _dense_conditional(smp, w, pool_ids, logq1, h)
    o, s = smp.slot_logits(rt, tpool, tlogq1, torch.from_numpy(h))
    np.testing.assert_allclose(s.numpy(), s_want, rtol=1e-5, atol=1e-5)
    slots_logq = o - torch.logsumexp(s, dim=-1, keepdim=True)
    np.testing.assert_allclose(slots_logq.numpy(),
                               composed[:, np.asarray(pool_ids)],
                               rtol=1e-4, atol=1e-4)
    ids, logq = smp.resample_from_pool(rt, tpool, tlogq1,
                                       torch.from_numpy(h), 60_000,
                                       torch.Generator().manual_seed(4))
    assert ids.shape == logq.shape == (T, 60_000)
    for t in range(T):
        np.testing.assert_allclose(logq[t].numpy(),
                                   composed[t, ids[t].numpy()], rtol=1e-4,
                                   atol=1e-4)
        _check_against(ids[t].numpy(), q2[t],
                       f"tapas[{base_name}] stage 2 [query {t}]")


@pytest.mark.parametrize("base_name", BASES)
def test_two_pass_frequencies_match_bruteforce_oracle(base_name):
    """The whole scheme: draw counts over 300 real pools (``draw_pool`` then
    ``resample_from_pool``, what ``sample_batch`` runs) against the sum of
    the brute-force conditionals of the SAME pools."""
    w, h = _inputs(seed=5)
    smp, rt = _mine(base_name, w)
    h1 = torch.from_numpy(h[:1])
    gen = torch.Generator().manual_seed(6)
    counts = np.zeros(N)
    expected = np.zeros(N)
    reps, m = 300, 200
    for _ in range(reps):
        pool_ids, lq1 = smp.draw_pool(rt, h1, gen)
        ids, _ = smp.resample_from_pool(rt, pool_ids, lq1, h1, m, gen)
        counts += np.bincount(ids[0].numpy(), minlength=N)
        q2, _, _ = _dense_conditional(smp, w, pool_ids.numpy(),
                                      lq1.numpy(), h[:1])
        expected += q2[0]
    expected /= reps
    assert abs(expected.sum() - 1.0) < 1e-6
    _check_counts(counts, expected,
                  f"tapas[{base_name}] two-pass vs brute-force oracle",
                  reps * m)


@pytest.mark.parametrize("base_name", BASES)
def test_partition_estimate_unbiased_zero_conditional_variance(base_name):
    """mean_b exp(o_b - logq_b) estimates Z = sum_j exp(o_j) without bias,
    and at tau = 1 the corrected logit is constant along each call's row."""
    w, h = _inputs(seed=7)
    smp, rt = _mine(base_name, w)
    h0 = torch.from_numpy(h[0])
    z_true = np.exp(w.astype(np.float64) @ h[0].astype(np.float64)).sum()
    gen = torch.Generator().manual_seed(8)
    z_hat, spread = [], []
    for _ in range(400):
        ids, logq = smp.sample(rt, h0, 32, gen)
        corrected = torch.from_numpy(w)[ids] @ h0 - logq
        z_hat.append(float(torch.mean(torch.exp(corrected))))
        spread.append(float(corrected.max() - corrected.min()))
    rel = abs(np.mean(z_hat) - z_true) / z_true
    assert rel < 0.03, (np.mean(z_hat), z_true)
    assert max(spread) < 1e-3


def test_pool_corners():
    """Duplicate pool draws weigh by multiplicity (composed mass <= 1),
    m > pool resamples with replacement, a single query, one pool a row
    (independent repetitions), and label hits flowing into every
    estimator finite, with the masked loss dropping collided slots."""
    w, h = _inputs(seed=9, n=8, t=3)
    smp, rt = _mine("uniform", w, pool=64)
    gen = torch.Generator().manual_seed(10)
    th = torch.from_numpy(h)
    pool_ids, logq1 = smp.draw_pool(rt, th, gen)
    assert np.bincount(pool_ids.numpy(), minlength=8).max() > 1
    ids, logq = smp.resample_from_pool(rt, pool_ids, logq1, th, 16, gen)
    assert torch.isfinite(logq).all() and (logq <= 1e-5).all()
    _, composed, _ = _dense_conditional(smp, w, pool_ids.numpy(),
                                        logq1.numpy(), h)
    for t in range(3):
        mass = np.exp(composed[t][np.isfinite(composed[t])]).sum()
        assert 0.0 < mass <= 1.0 + 1e-6

    smp16, rt16 = _mine("uniform", _inputs(seed=11, n=32)[0], pool=16)
    ids, logq = smp16.sample_batch(rt16, th, 48, gen)
    assert ids.shape == (3, 48) and torch.isfinite(logq).all()
    assert all(len(torch.unique(ids[t])) <= 16 for t in range(3))
    one, lq1 = smp16.sample(rt16, th[0], 8, gen)
    assert one.shape == lq1.shape == (8,)
    # one pool a row: row r resampled against its own pool only
    pools = torch.stack([smp16.draw_pool(rt16, th, gen)[0]
                         for _ in range(3)])
    lqs = torch.full(pools.shape, -np.log(32.0))
    rid, rlq = smp16.resample_from_pool(rt16, pools, lqs, th, 10, gen)
    for r in range(3):
        assert set(rid[r].tolist()) <= set(pools[r].tolist())
        o, s = smp16.slot_logits(rt16, pools[r], lqs[r], th[r:r + 1])
        want = (o - torch.logsumexp(s, -1, keepdim=True))[0]
        pos = {int(c): float(v) for c, v in zip(pools[r], want)}
        np.testing.assert_allclose(rlq[r].numpy(),
                                   [pos[int(c)] for c in rid[r]],
                                   rtol=1e-6, atol=1e-6)

    smp6, rt6 = _mine("uniform", _inputs(seed=12, n=6)[0], pool=32)
    w6 = rt6["w"]
    h4 = torch.from_numpy(_inputs(seed=13, t=4)[1])
    labels = torch.tensor([0, 3, 5, 2])
    ids, logq = smp6.sample_batch(rt6, h4, 24, gen)
    hit = ids == labels[:, None]
    assert hit.any()
    loss = estimators.loss_from_embeddings(
        estimators.make_estimator("sampled-softmax"), w6, h4, labels, ids,
        logq)
    o = (h4.double() @ w6.double().T)
    pos = o[torch.arange(4), labels]
    adj = torch.gather(o, 1, ids) - logq.double() - np.log(24)
    adj[hit] = -np.inf
    want = torch.logsumexp(torch.cat([pos[:, None], adj], 1), 1) - pos
    np.testing.assert_allclose(loss.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
    logistic, nce = (estimators.loss_from_embeddings(
        estimators.make_estimator(n), w6, h4, labels, ids, logq)
        for n in ("sampled-logistic", "nce"))
    assert (nce - logistic).min() > -1e-6 and (nce - logistic).max() > 1e-6


def test_registry_validation_and_delegation():
    assert "tapas" in samplers.sampler_names()
    with pytest.raises(ValueError, match="cannot nest"):
        TapasSampler(base=TapasSampler())
    with pytest.raises(ValueError, match="pool size"):
        TapasSampler(pool=0)
    with pytest.raises(ValueError, match="tau"):
        TapasSampler(tau=0.0)
    with pytest.raises(ValueError, match="tapas"):
        get_config("youtube-dnn").reduced(sampler="tapas",
                                          tapas_pool=-4).validate()
    uni = TapasSampler(base=samplers.make_sampler("uniform"), pool=8)
    assert not uni.carries_state and uni.two_stage
    blk = TapasSampler(base=samplers.make_sampler(
        "block-quadratic-shared", block_size=4), pool=8)
    assert blk.carries_state
    with pytest.raises(TypeError, match="island_runtime"):
        uni.hydrate(None, None)
    w = torch.randn((16, 4), generator=torch.Generator().manual_seed(0))
    rt = uni.island_runtime(None, w, 16)
    assert set(rt) == {"base", "w", "n_valid"} and rt["w"] is w
    cfg = get_config("youtube-dnn").reduced(sampler="tapas")
    smp = samplers.sampler_from_config(cfg)
    assert (smp.pool, smp.tau, smp.base.shared, smp.base.block_size) == (
        cfg.tapas_pool, cfg.tapas_tau, True, cfg.sampler_block)
    assert smp.state_shapes(cfg).stats.keys() == {"z", "cnt", "wq"}


def _facade_cfg(**over):
    base = dict(vocab_size=128, m_negatives=16, sampler="tapas",
                tapas_pool=64, tapas_base="block-quadratic-shared",
                sampler_block=16, tower_dims=(64, 32), user_feature_dim=64,
                history_len=3)
    base.update(over)
    return get_config("youtube-dnn").reduced(**base)


def test_facade_sample_and_loss_are_the_train_path(monkeypatch):
    """``SoftmaxHead.sample`` needs ``w=``; its loss is
    ``local_sampled_loss`` bitwise, the train step's path, whose runtime
    state is {"base", "w", "n_valid"} with the detached head; dL/dw and
    dL/dh are finite and nonzero."""
    cfg = _facade_cfg()
    head = SoftmaxHead(cfg)
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((128, 32), generator=gen) * 0.3
    h = torch.randn((5, 32), generator=gen)
    labels = torch.randint(0, 128, (5,), generator=gen)
    state = head.init(torch.Generator().manual_seed(1), w)
    with pytest.raises(ValueError, match="pass w="):
        head.sample(state, h, torch.Generator())
    ids, logq = head.sample(state, h, torch.Generator(), w=w)
    assert ids.shape == logq.shape == (5, 16)
    seen = []
    real = TapasSampler.sample_batch

    def spy(self, runtime, *a):
        seen.append(runtime)
        return real(self, runtime, *a)
    monkeypatch.setattr(TapasSampler, "sample_batch", spy)
    tw, th = w.clone().requires_grad_(), h.clone().requires_grad_()
    loss = head.loss(tw, th, labels, state=state,
                     key=torch.Generator().manual_seed(4))
    loss.sum().backward()
    direct = estimators.local_sampled_loss(
        head.estimator, head.sampler, w, h, labels, state,
        cfg.m_negatives, torch.Generator().manual_seed(4),
        n_valid=cfg.vocab_size, abs_mode=cfg.abs_softmax,
        impl=cfg.head_impl)
    assert torch.equal(loss.detach(), direct)
    assert set(seen[0]) == {"base", "w", "n_valid"}
    assert not seen[0]["w"].requires_grad
    for g in (tw.grad, th.grad):
        assert torch.isfinite(g).all() and float(g.norm()) > 0


@pytest.mark.parametrize("model,base", [("youtube-dnn", None),
                                        ("youtube-dnn", "uniform"),
                                        ("youtube-dnn", "tree-quadratic"),
                                        ("ptb-lstm", None)])
def test_fit_three_steps(model, base):
    """Three ``fit`` steps of tapas at ``reduced()`` (pool 128: the mega
    branch of the shared base), and over a non-shared base (one pool from
    the mean query): finite losses; the carried state is the base's."""
    cfg = get_config(model).reduced(sampler="tapas")
    if base:
        cfg = dataclasses.replace(cfg, tapas_base=base)
    seq = 8 if model == "ptb-lstm" else 1
    data = batch_iterator_for(cfg, None, 16, seq, seed=0, device="cpu")
    res = loop.fit(cfg, None, make_optimizer("adamw", 1e-2), data, 3,
                   log_every=0, device="cpu")
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    want = samplers.sampler_from_config(cfg).base.state_shapes(cfg)
    assert set(res.state.sampler_state.stats) == set(want.stats)
