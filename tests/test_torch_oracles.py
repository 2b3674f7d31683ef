"""The port's comparison samplers — the logit oracles (softmax, abs-softmax,
quadratic-oracle, quartic-oracle), ``rff-oracle``, ``midx-oracle``, unigram
and bigram — against the JAX package, on the CPU.

Deterministic parts are compared on the same numpy inputs: every oracle's
``logq_all`` within 1e-4 (rff-oracle with the reference's own directions
omega, passed across; midx-oracle on the index each package builds from
the same table, whose ``perm`` and ``codes`` are equal), unigram's and
bigram's ``set_counts`` within 1e-5.  Draws come from ``torch.Generator``s
and are held to the reference's distribution by the chi-square/TV gate of
``tests/test_sampler_stats.py``.  Then the train step: the oracles carry
no state and rebuild from the detached head each step, three ``fit`` steps
per family, and the reference's checkpoint round trip of
``tests/test_sampler_state.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_fns as jkf
from repro.core import samplers as jsamplers
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import estimators, samplers
from repro_torch.core import kernel_fns as kf
from repro_torch.core.samplers import SamplerState
from repro_torch.data.pipeline import batch_iterator_for
from repro_torch.optim import make_optimizer
from repro_torch.train import loop, step
from test_sampler_stats import _check_against

torch.set_num_threads(1)

N, D, T = 96, 12, 3
LOGIT = ["softmax", "abs-softmax", "quadratic-oracle", "quartic-oracle"]
ORACLES = LOGIT + ["rff-oracle", "midx-oracle"]
RFF_DIM = 64


def _inputs(seed=0, n=N, t=T, scale=0.5):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n, D)) * scale).astype(np.float32),
            rng.normal(size=(t, D)).astype(np.float32))


def _pair(name, w, n_valid):
    """(port sampler, its runtime, reference sampler, its runtime) for the
    table w with ``n_valid`` real rows (None: the reference's ``init``)."""
    if name == "rff-oracle":
        omega = jkf.rff_directions(jax.random.PRNGKey(0), RFF_DIM, D)
        theirs = jsamplers.rff_oracle(RFF_DIM)
        mine = samplers.rff_oracle(RFF_DIM,
                                   omega=torch.from_numpy(np.array(omega)))
    elif name == "midx-oracle":
        theirs = jsamplers.MIDXOracleSampler(codewords=4, list_size=8)
        mine = samplers.MIDXOracleSampler(codewords=4, list_size=8)
    else:
        theirs, mine = jsamplers.make_sampler(name), samplers.make_sampler(name)
    tw = torch.from_numpy(w)
    nv = w.shape[0] if n_valid is None else n_valid
    rt = mine.island_state(tw, nv)
    if n_valid is None and name != "midx-oracle":
        jrt = theirs.init(None, jnp.asarray(w))
    else:
        jrt = jax.jit(theirs.island_state)(jnp.asarray(w),
                                           jnp.asarray(nv, jnp.int32))
    return mine, rt, theirs, jrt


def _ref_logq(theirs, jrt, h):
    fn = jax.jit(lambda r, h_: theirs.logq_all(r, h_))
    return np.stack([np.asarray(fn(jrt, jnp.asarray(x))) for x in h])


@pytest.mark.parametrize("n_valid", [None, 90])
@pytest.mark.parametrize("name", ORACLES)
def test_logq_all_matches_reference(name, n_valid):
    """One query (d,) and the batch (T, d) at once, every class; with
    n_valid the padding rows are -inf in the port (the reference leaves
    them at log(1e-30) - log Z, below -60)."""
    w, h = _inputs(seed=len(name))
    mine, rt, theirs, jrt = _pair(name, w, n_valid)
    want = _ref_logq(theirs, jrt, h)
    got = mine.logq_all(rt, torch.from_numpy(h)).numpy()
    one = mine.logq_all(rt, torch.from_numpy(h[1])).numpy()
    np.testing.assert_allclose(one, got[1], rtol=1e-6, atol=1e-6)
    nv = N if n_valid is None else n_valid
    np.testing.assert_allclose(got[:, :nv], want[:, :nv], rtol=1e-4,
                               atol=1e-4)
    assert np.isneginf(got[:, nv:]).all() and (want[:, nv:N] < -60).all()


def test_rff_kernel_directions():
    """``rff_kernel``: the exact exp kernel, phi from given directions equal
    to the reference's phi, directions drawn from a generator once per
    input width and reused."""
    omega = jkf.rff_directions(jax.random.PRNGKey(3), RFF_DIM, D)
    _, h = _inputs(seed=3)
    mine = kf.rff_kernel(RFF_DIM, 0.5, omega=torch.from_numpy(
        np.array(omega)))
    want = jkf.rff_phi(jnp.asarray(h), omega, 0.5)
    np.testing.assert_allclose(mine.phi(torch.from_numpy(h)).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-7)
    t = torch.linspace(-2, 2, 9)
    np.testing.assert_allclose(
        mine.of_dot(t).numpy(),
        np.asarray(jkf.rff_kernel(RFF_DIM, 0.5).of_dot(jnp.asarray(t))),
        rtol=1e-6)
    drawn = kf.rff_kernel(RFF_DIM, gen=torch.Generator().manual_seed(4))
    a = drawn.phi(torch.from_numpy(h))
    assert torch.equal(a, drawn.phi(torch.from_numpy(h)))
    seeded = kf.rff_kernel(RFF_DIM, seed=4)
    assert torch.equal(a, seeded.phi(torch.from_numpy(h)))
    with pytest.raises(ValueError, match="rows"):
        kf.rff_kernel(RFF_DIM + 1, omega=torch.zeros(RFF_DIM, D))


@pytest.mark.parametrize("name", ORACLES)
def test_batched_draws_pass_the_chi_square_gate(name):
    """60,000 draws per query as one (T, n) product and one multinomial:
    frequencies against the reference's distribution, logq equal to
    ``logq_all`` at the ids, none at or past n_valid."""
    w, h = _inputs(seed=10 + len(name), t=2, scale=0.3)
    mine, rt, theirs, jrt = _pair(name, w, 90)
    ids, logq = mine.sample_batch(rt, torch.from_numpy(h), 60_000,
                                  torch.Generator().manual_seed(1))
    assert ids.shape == logq.shape == (2, 60_000) and int(ids.max()) < 90
    table = mine.logq_all(rt, torch.from_numpy(h))
    np.testing.assert_array_equal(logq.numpy(),
                                  torch.gather(table, 1, ids).numpy())
    want = np.exp(_ref_logq(theirs, jrt, h).astype(np.float64))[:, :90]
    for t in range(2):
        _check_against(ids[t].numpy(), want[t] / want[t].sum(),
                       f"{name}[query {t}]")


def test_unigram_and_bigram_match_reference():
    """``set_counts`` of both, unigram's draws by the chi-square gate, and
    the reference's ``test_bigram_conditional`` case."""
    counts = np.arange(1.0, 41.0, dtype=np.float32) ** 1.5
    for distortion in (1.0, 0.75):
        mine = samplers.UnigramSampler(distortion=distortion)
        theirs = jsamplers.UnigramSampler(distortion=distortion)
        w = torch.zeros(40, 2)
        st = mine.set_counts(mine.init(None, w), torch.from_numpy(counts))
        jst = theirs.set_counts(theirs.init(None, jnp.zeros((40, 2))),
                                jnp.asarray(counts))
        np.testing.assert_allclose(st["logp"].numpy(),
                                   np.asarray(jst["logp"]), rtol=1e-5,
                                   atol=1e-6)
    ids, logq = mine.sample_batch(st, torch.zeros(2, 2), 30_000,
                                  torch.Generator().manual_seed(2))
    assert ids.shape == (2, 30_000)
    np.testing.assert_array_equal(logq.numpy(), st["logp"][ids].numpy())
    _check_against(ids.numpy(), np.exp(np.asarray(jst["logp"],
                                                  np.float64)), "unigram")
    assert not samplers.make_sampler("unigram").supports_head_loss()

    bigram, jbigram = samplers.BigramSampler(), jsamplers.BigramSampler()
    table = np.random.default_rng(3).uniform(0, 50, (6, 6)).astype(
        np.float32)
    st = bigram.set_counts(bigram.init(None, torch.zeros(6, 2)),
                           torch.from_numpy(table))
    jst = jbigram.set_counts(jbigram.init(None, jnp.zeros((6, 2))),
                             jnp.asarray(table))
    np.testing.assert_allclose(st["logp"].numpy(), np.asarray(jst["logp"]),
                               rtol=1e-5, atol=1e-6)
    # the reference's case: next == prev with high probability
    st = bigram.set_counts(bigram.init(None, torch.zeros(6, 2)),
                           torch.eye(6) * 100.0)
    ids, logq = bigram.sample_ctx(st, torch.tensor(4), 200,
                                  torch.Generator().manual_seed(1))
    assert ids.shape == (200,) and float((ids == 4).float().mean()) > 0.9
    np.testing.assert_array_equal(logq.numpy(), st["logp"][4][ids].numpy())
    ids2, _ = bigram.sample_ctx(st, torch.tensor([1, 4]), 5,
                                torch.Generator())
    assert ids2.shape == (2, 5)
    with pytest.raises(ValueError, match="Sampler protocol"):
        samplers.make_sampler("bigram")


def _cfg(family, **over):
    base = dict(vocab_size=128, m_negatives=16, sampler=family,
                sampler_block=16, rff_dim=32, tower_dims=(64, 32),
                user_feature_dim=64, history_len=3)
    base.update(over)
    return get_config("youtube-dnn").reduced(**base)


@pytest.mark.parametrize("name", ORACLES)
def test_oracle_rebuilds_from_the_detached_head(name):
    """``local_sampled_loss`` with a non-carrying oracle equals the loss at
    the draws of ``island_state(w.detach())`` from the same generator seed,
    value and dL/dw: the runtime state is rebuilt from the head the call is
    given, and no gradient reaches the sampler."""
    cfg = _cfg(name)
    smp = samplers.sampler_from_config(cfg)
    assert not smp.carries_state and smp.supports_head_loss()
    est = estimators.make_estimator(cfg.estimator)
    w_np, h_np = _inputs(seed=20, n=128, t=6)
    labels = torch.arange(6) * 7
    losses, grads = [], []
    for direct in (False, True):
        w = torch.from_numpy(w_np).requires_grad_()
        h = torch.from_numpy(h_np)
        gen = torch.Generator().manual_seed(5)
        if direct:
            with torch.no_grad():
                neg, logq = smp.sample_batch(
                    smp.island_state(w.detach(), 128), h, 16, gen)
            loss = estimators.loss_from_embeddings(
                est, w, h, labels, neg, logq, abs_mode=cfg.abs_softmax)
        else:
            loss = estimators.local_sampled_loss(
                est, smp, w, h, labels, samplers.empty_state(), 16, gen,
                n_valid=128, abs_mode=cfg.abs_softmax)
        loss.sum().backward()
        losses.append(loss.detach())
        grads.append(w.grad)
    assert torch.equal(losses[0], losses[1])
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("name", ORACLES)
def test_fit_three_steps(name):
    """Three ``fit`` steps of each oracle at ``reduced()``: finite losses,
    nothing carried."""
    cfg = get_config("youtube-dnn").reduced(sampler=name)
    data = batch_iterator_for(cfg, None, 16, 1, seed=0, device="cpu")
    res = loop.fit(cfg, None, make_optimizer("adamw", 1e-2), data, 3,
                   log_every=0, device="cpu")
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    assert res.state.sampler_state.stats == {}
    assert res.state.sampler_state.const == {}


#: family -> carried stats keys (empty: non-carrying), as the reference's
#: tests/test_sampler_state.py declares them
STATE_FAMILIES = {
    "block-quadratic-shared": {"z", "cnt", "wq"},
    "tapas": {"z", "cnt", "wq"},
    "softmax": set(), "abs-softmax": set(), "quadratic-oracle": set(),
    "quartic-oracle": set(), "rff-oracle": set(), "midx-oracle": set(),
}


@pytest.mark.parametrize("family", sorted(STATE_FAMILIES))
def test_state_round_trips_a_checkpoint(family, tmp_path):
    """The reference's ``test_state_is_self_describing`` and
    ``test_checkpoint_roundtrip`` for the new families: the built state has
    the declared keys, shapes and types, and a TrainState holding it
    survives save / restore bitwise."""
    cfg = _cfg(family)
    smp = samplers.sampler_from_config(cfg)
    w = torch.randn((cfg.vocab_size, 32),
                    generator=torch.Generator().manual_seed(0)) * 0.3
    state = smp.init_state(torch.Generator().manual_seed(1), w)
    assert isinstance(state, SamplerState)
    assert set(state.stats) == STATE_FAMILIES[family]
    shapes = smp.state_shapes(cfg)
    for k, sds in shapes.stats.items():
        assert state.stats[k].shape == sds.shape, (family, k)
        assert state.stats[k].dtype == sds.dtype, (family, k)
    assert set(shapes.const) == set(state.const)
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    st = step.init_train_state(torch.Generator().manual_seed(0), cfg, None,
                               opt, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, st, extra={"step": 1}, blocking=True)
    like = step.abstract_train_state(cfg, None, opt)
    restored, extra = mgr.restore(like=like, device="cpu")
    assert extra["step"] == 1
    for part in ("stats", "const"):
        got = getattr(restored.sampler_state, part)
        want = getattr(st.sampler_state, part)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (family, part, k)
