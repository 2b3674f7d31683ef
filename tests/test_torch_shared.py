"""The port's batch-shared sampler (``block-quadratic-shared``, the config
default), ``categorical_rows`` and the tree's per-draw reference descent
against the JAX package, on the CPU.

Deterministic parts are compared on the same numpy inputs: the context Gram
within rtol 1e-5; ``all_class_logq(shared=True)``, the block and the
within-block log-probabilities of both ``sample_shared`` branches (per-draw
and mega-batch), with and without a JL projection, within 1e-4; the
reference's own draws' logq against the port's all-class oracle within
1e-4; a train step at fixed shared negatives (loss and every gradient of
the three sampled estimators) within rtol 1e-5.  Draws come from
``torch.Generator``s, so they are held to the reference's distribution by
the chi-square/TV gate of ``tests/test_sampler_stats.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import blocks as jblocks
from repro.core import estimators as jest
from repro.core import kernel_fns as jkf
from repro.core import samplers as jsamplers
from repro.core import tree as jtree
from repro.models import api as japi
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.core import blocks, estimators, hierarchy, samplers, tree
from repro_torch.core import kernel_fns as kf
from repro_torch.data.pipeline import batch_iterator_for
from repro_torch.models import api
from repro_torch.optim import make_optimizer
from repro_torch.train import loop, step
from test_sampler_stats import _check_against
from test_torch_train import CTX, _batches, _carried, _t

torch.set_num_threads(1)

N, BLOCK, D, T = 100, 16, 12, 5   # 7 blocks; the last holds 4 real rows
K, JK = kf.quadratic_kernel(100.0), jkf.quadratic_kernel(100.0)
DRAWS = 60_000

_jbuild = jax.jit(jblocks.build, static_argnums=(1,))
_jall_shared = jax.jit(
    lambda st, h, p: jblocks.all_class_logq(st, JK, h, p, shared=True))


def _inputs(seed=0, rank=None, n=N, t=T):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(n, D)) * 0.5).astype(np.float32)
    h = rng.normal(size=(t, D)).astype(np.float32)
    proj = (None if rank is None else
            (rng.normal(size=(rank, D)) / np.sqrt(rank)).astype(np.float32))
    return w, h, proj


def _both(w, proj, block=BLOCK):
    tp = None if proj is None else torch.from_numpy(proj)
    jp = None if proj is None else jnp.asarray(proj)
    return (blocks.build(torch.from_numpy(w), block, tp), tp,
            _jbuild(jnp.asarray(w), block, jp), jp)


def _ref_logq(jst, h, jp) -> np.ndarray:
    return np.asarray(_jall_shared(jst, jnp.asarray(h), jp))


def _close_logq(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=tol, atol=tol)


def test_batch_context_gram_matches_reference():
    _, h, _ = _inputs()
    gram, t = blocks.batch_context_gram(torch.from_numpy(h))
    jgram, jt = jax.jit(jblocks.batch_context_gram)(jnp.asarray(h))
    np.testing.assert_allclose(gram.numpy(), np.asarray(jgram), rtol=1e-5,
                               atol=1e-6)
    assert float(t) == float(jt) == T


@pytest.mark.parametrize("rank", [None, 8])
def test_all_class_logq_shared_matches_reference(rank):
    """The exact batch-summed distribution over all classes, padding rows
    of the last block at -inf in both."""
    w, h, proj = _inputs(seed=1, rank=rank)
    mine, tp, theirs, jp = _both(w, proj)
    got = blocks.all_class_logq(mine, K, torch.from_numpy(h), tp,
                                shared=True)
    _close_logq(got.numpy(), _ref_logq(theirs, h, jp))
    assert np.isneginf(got.numpy()[N:]).all()


@pytest.mark.parametrize("rank", [None, 8])
def test_block_masses_and_both_within_branches_match_reference(rank):
    """The shared block log-probabilities and the within-block
    log-probabilities of the per-draw branch (gathered rows @ HH) and of the
    mega branch (every block scored once, gathered) against the reference's
    all-class distribution split by block; the two branches agree."""
    w, h, proj = _inputs(seed=2, rank=rank)
    mine, tp, theirs, jp = _both(w, proj)
    ref = _ref_logq(theirs, h, jp).reshape(mine.n_blocks, BLOCK)
    ref_blk = np.logaddexp.reduce(ref, axis=1)
    hh = blocks.shared_context(torch.from_numpy(h), tp)
    got_blk = blocks.shared_block_log_probs(mine, K, hh, T)
    np.testing.assert_allclose(got_blk.numpy(), ref_blk, rtol=1e-4,
                               atol=1e-4)
    blk = torch.tensor([6, 0, 3, 6, 2, 5, 1, 4, 6])
    branches = [torch.log_softmax(blocks.shared_within_logits(
        mine, K, hh, T, blk, mega=mega), dim=-1) for mega in (False, True)]
    want = ref[blk.numpy()] - ref_blk[blk.numpy(), None]
    for got in branches:
        _close_logq(got.numpy(), want)
    _close_logq(branches[0].numpy(), branches[1].numpy(), tol=1e-5)


@pytest.mark.parametrize("m", [8, 4 * 7])
def test_reference_draws_report_the_ports_logq(m):
    """The reference's own shared draws (per-draw branch at m = 8, the mega
    branch at m = 4 * n_blocks) carry the logq the port's all-class oracle
    gives their ids."""
    w, h, proj = _inputs(seed=3, rank=8)
    mine, tp, theirs, jp = _both(w, proj)
    ids, logq = jax.jit(
        lambda st, h_, p, k: jblocks.sample_shared(st, JK, h_, m, k, p))(
        theirs, jnp.asarray(h), jp, jax.random.PRNGKey(4))
    oracle = blocks.all_class_logq(mine, K, torch.from_numpy(h), tp,
                                   shared=True)
    np.testing.assert_allclose(oracle.numpy()[np.asarray(ids)],
                               np.asarray(logq), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rank", [None, 8])
@pytest.mark.parametrize("mega", [False, True])
def test_shared_draws_pass_the_chi_square_gate(mega, rank):
    """60,000 draws of the per-draw branch (3,000 calls of m = 20) and of the
    mega branch (one call): frequencies against the reference's exact
    distribution, logq against the port's oracle, no id at or past n."""
    w, h, proj = _inputs(seed=4, rank=rank)
    mine, tp, theirs, jp = _both(w, proj)
    gen = torch.Generator().manual_seed(5)
    th = torch.from_numpy(h)
    if mega:
        assert blocks.is_mega(mine, DRAWS)
        ids, logq = blocks.sample_shared(mine, K, th, DRAWS, gen, tp)
    else:
        assert not blocks.is_mega(mine, 20)
        draws = [blocks.sample_shared(mine, K, th, 20, gen, tp)
                 for _ in range(DRAWS // 20)]
        ids = torch.cat([i for i, _ in draws])
        logq = torch.cat([lq for _, lq in draws])
    assert ids.shape == logq.shape == (DRAWS,) and int(ids.max()) < N
    oracle = blocks.all_class_logq(mine, K, th, tp, shared=True)
    np.testing.assert_allclose(logq.numpy(), oracle[ids].numpy(),
                               rtol=1e-5, atol=1e-5)
    _check_against(ids.numpy(), np.exp(_ref_logq(theirs, h, jp)),
                   f"shared ({'mega' if mega else 'per-draw'}, "
                   f"rank {rank})")


def test_sampler_protocol_draws_one_shared_set():
    """BlockSampler(shared=True) through build_stats / hydrate draws (m,),
    its ``sample`` one set for one query; ``all_class_logq`` is shared."""
    w, h, _ = _inputs(seed=6)
    smp = samplers.make_sampler("block-quadratic-shared", block_size=BLOCK)
    gen = torch.Generator().manual_seed(0)
    rt = smp.hydrate(smp.init_state(gen, torch.from_numpy(w)), N)
    ids, logq = smp.sample_batch(rt, torch.from_numpy(h), 32, gen)
    assert ids.shape == logq.shape == (32,)
    np.testing.assert_allclose(
        logq.numpy(), smp.all_class_logq(rt, torch.from_numpy(h))[ids],
        rtol=1e-5, atol=1e-5)
    one, lq1 = smp.sample(rt, torch.from_numpy(h[0]), 7, gen)
    assert one.shape == lq1.shape == (7,)


def test_categorical_rows_frequencies():
    """One uniform a draw, inverse CDF: frequencies of 60,000 draws per row
    against softmax(logits), -inf slots never drawn."""
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(3, 10)).astype(np.float32) * 2
    logits[:, 4] = -np.inf
    slots = blocks.categorical_rows(torch.Generator().manual_seed(8),
                                    torch.from_numpy(logits), DRAWS)
    assert slots.shape == (3, DRAWS) and slots.dtype == torch.int64
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    for r in range(3):
        assert not (slots[r] == 4).any()
        _check_against(slots[r].numpy(), probs[r], f"categorical_rows[{r}]")


def test_categorical_rows_never_draws_padding(monkeypatch):
    """The edge of the reference's clip to the last slot: rows of 256 slots
    whose last 96 are padding (a padded last block), with an fp32 cdf[-1]
    short of 1 - 2^-23.  A forced uniform of 1 - 2^-23 (the reference's
    largest) lands past cdf[-1], and the reference clips it onto slot 255,
    a padding row; the port's draw with the same uniform stays on a live
    slot."""
    rng = np.random.default_rng(9)
    logits = np.full((200, 256), -np.inf, np.float32)
    logits[:, :160] = rng.normal(size=(200, 160)) * 2
    cdf = np.asarray(jnp.cumsum(jax.nn.softmax(jnp.asarray(logits), -1), -1))
    short = cdf[:, -1] < np.float32(1 - 2.0 ** -23)
    assert short.sum() >= 1
    top = 1.0 - 2.0 ** -23
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.full(shape, top, dtype))
    ref = np.asarray(jblocks.categorical_rows(jax.random.PRNGKey(0),
                                              jnp.asarray(logits), 1))[:, 0]
    assert (ref[short] == 255).all()  # the reference's padding draw
    monkeypatch.setattr(torch, "rand", lambda shape, generator=None,
                        device=None: torch.full(shape, top, device=device))
    mine = blocks.categorical_rows(None, torch.from_numpy(logits), 1)[:, 0]
    assert int(mine.max()) < 160
    assert np.isfinite(logits[np.arange(200), mine.numpy()]).all()


def _tree(n=64, leaf=8, seed=10):
    w, h, _ = _inputs(seed=seed, n=n)
    return tree.build(torch.from_numpy(w), K, leaf), \
        jax.jit(lambda w_: jtree.build(w_, JK, leaf))(jnp.asarray(w)), h


def test_sample_sequential_matches_the_batched_descent():
    """The paper's per-draw descent against ``hierarchy.descend`` at
    dense_cap = 0 under the port's generator: both pass the chi-square gate
    against the tree's exact distribution, and both report it as logq."""
    mine, theirs, h = _tree()
    hq = torch.from_numpy(h[0])
    oracle = tree.all_class_logq(mine, K, hq)
    _close_logq(oracle.numpy(), np.asarray(
        jax.jit(lambda s, h_: jtree.all_class_logq(s, JK, h_))(
            theirs, jnp.asarray(h[0]))), tol=1e-5)
    gen = torch.Generator().manual_seed(11)
    seq_ids, seq_logq = tree.sample_sequential(mine, K, hq, 3000, gen)
    bat_ids, bat_logq = hierarchy.descend(mine, K, hq[None], DRAWS, gen,
                                          dense_cap=0)
    q = np.exp(oracle.numpy())
    for ids, logq, tag in ((seq_ids, seq_logq, "sequential"),
                           (bat_ids[0], bat_logq[0], "batched")):
        np.testing.assert_allclose(logq.numpy(), oracle[ids].numpy(),
                                   rtol=1e-5, atol=1e-5)
        _check_against(ids.numpy(), q, f"tree descent ({tag})")
    # the reference's sequential draws carry the port's exact logq
    jids, jlogq = jax.jit(lambda s, h_, k: jtree.sample_sequential(
        s, JK, h_, 64, k))(theirs, jnp.asarray(h[0]), jax.random.PRNGKey(12))
    np.testing.assert_allclose(oracle.numpy()[np.asarray(jids)],
                               np.asarray(jlogq), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["sampled-softmax", "nce",
                                  "sampled-logistic"])
def test_step_at_fixed_shared_negatives_matches_reference(name):
    """A reference youtube-dnn state with the shared family carried into the
    port: the refresh rebuilds the same statistics, the reference's shared
    draws carry the port's logq, and the loss and every parameter gradient
    of the estimator at those (m,) negatives agree."""
    jcfg = jget_config("youtube-dnn").reduced(
        sampler="block-quadratic-shared", estimator=name)
    cfg = get_config("youtube-dnn").reduced(
        sampler="block-quadratic-shared", estimator=name)
    jopt = jmake_optimizer("adamw", 1e-2)
    state_j = jax.jit(lambda k: jstep.init_train_state(k, jcfg, CTX, jopt))(
        jax.random.PRNGKey(0))
    mine = _carried(state_j, cfg)
    want = jax.jit(jstep.make_refresh_fn(jcfg, CTX))(
        japi.head_table(state_j.params, jcfg), state_j.sampler_state)
    got = step.make_refresh_fn(cfg, None)(api.head_table(mine.params, cfg),
                                          mine.sampler_state)
    for k in ("z", "cnt", "wq"):
        np.testing.assert_allclose(got.stats[k].numpy(),
                                   np.asarray(want.stats[k]), rtol=1e-5,
                                   atol=1e-6)
    batch_np = _batches(jcfg, 1)[0]
    batch = {k: _t(v) for k, v in batch_np.items()}
    jsmp = jsamplers.sampler_from_config(jcfg)
    jh, _, _ = japi.backbone_hidden(state_j.params, batch_np, jcfg, CTX)
    neg, logq = jsmp.sample_batch(jsmp.hydrate(want, cfg.vocab_size), jh,
                                  cfg.m_negatives, jax.random.PRNGKey(3))
    assert neg.shape == (cfg.m_negatives,)
    smp = samplers.sampler_from_config(cfg)
    rt = smp.hydrate(got, cfg.vocab_size)
    with torch.no_grad():
        h, _, _ = api.backbone_hidden(mine.params, batch, cfg)
    np.testing.assert_allclose(
        smp.all_class_logq(rt, h)[_t(neg)].numpy(), np.asarray(logq),
        rtol=1e-4, atol=1e-4)

    def jloss(params):
        hh, lab, _ = japi.backbone_hidden(params, batch_np, jcfg, CTX)
        return jnp.mean(jest.loss_from_embeddings(
            jest.make_estimator(name), japi.head_table(params, jcfg), hh,
            lab, neg, logq, abs_mode=jcfg.abs_softmax))
    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(state_j.params)
    hh, lab, _ = api.backbone_hidden(mine.params, batch, cfg)
    loss = torch.mean(estimators.loss_from_embeddings(
        estimators.make_estimator(name), api.head_table(mine.params, cfg),
        hh, lab, _t(neg), _t(logq), abs_mode=cfg.abs_softmax))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    from repro_torch import convert
    want_g = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads), cfg, device="cpu")
    for pname, p in mine.params.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   getattr(want_g, pname).detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=pname)


@pytest.mark.parametrize("model,rank", [("youtube-dnn", None),
                                        ("youtube-dnn", 16),
                                        ("ptb-lstm", None)])
def test_fit_three_steps(model, rank):
    """Three ``fit`` steps with the shared family at ``reduced()`` on the
    CPU (with the config default's JL projection too): finite losses, the
    carried statistics of the declared shapes."""
    cfg = get_config(model).reduced(sampler="block-quadratic-shared",
                                    sampler_proj_rank=rank)
    seq = 8 if model == "ptb-lstm" else 1
    data = batch_iterator_for(cfg, None, 16, seq, seed=0, device="cpu")
    res = loop.fit(cfg, None, make_optimizer("adamw", 1e-2), data, 3,
                   log_every=0, device="cpu")
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    shapes = samplers.sampler_from_config(cfg).state_shapes(cfg)
    assert {k: tuple(v.shape) for k, v in shapes.stats.items()} == \
        {k: tuple(v.shape) for k, v in res.state.sampler_state.stats.items()}
    assert set(res.state.sampler_state.const) == (
        {"proj"} if rank else set())
    assert dataclasses.replace(cfg).validate()
