"""The port's midx sampler (``core/midx.py``, the two midx ops and
``MIDXSampler``) against the JAX package, on the CPU.

Deterministic parts on the same numpy inputs: the build (``perm`` and
``codes`` equal; ``c1``, ``c2``, ``cnt`` and ``wq`` within 1e-5), k-means,
the quantized dots, both stages' log-scores and ``all_class_logq`` within
rtol 1e-5 (fp32 sums in other orders), and ``ops.midx_list_masses`` /
``ops.midx_member_scores`` against the reference's Pallas kernels in
interpret mode on ragged shapes with empty lists.  Draws are held to the
reference's ``all_class_logq`` by the chi-square/TV gate of
``tests/test_sampler_stats.py``.

Every table here has more lists than its rows fill, so the last lists are
EMPTY (cnt = 0) — as at youtube-dnn's full width, where 100,000 rows make
391 lists of 256 and 121 more that are empty."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_fns as jkf
from repro.core import midx as jmidx
from repro.core.blocks import categorical_rows
from repro.kernels import ops as jops
from repro_torch.core import kernel_fns as kf
from repro_torch.core import midx, samplers
from repro_torch.kernels import ops, ref
from test_sampler_stats import _check_against

torch.set_num_threads(1)

D = 12
K, JK = kf.quadratic_kernel(100.0), jkf.quadratic_kernel(100.0)


def _inputs(n, seed=0, scale=0.5, t=3):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n, D)) * scale).astype(np.float32),
            (rng.normal(size=(t, D)) * scale).astype(np.float32))


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


_jbuild = jax.jit(jmidx.build, static_argnames=("codewords", "codebooks",
                                                 "list_size"))
_jall_class_logq = jax.jit(lambda s, h: jmidx.all_class_logq(s, JK, h))


def _stats(w, codewords=4, list_size=8, codebooks=2):
    mine = midx.build(torch.from_numpy(w), codewords=codewords,
                      codebooks=codebooks, list_size=list_size)
    theirs = _jbuild(jnp.asarray(w), codewords=codewords,
                     codebooks=codebooks, list_size=list_size)
    return mine, theirs


@pytest.mark.parametrize("n,codebooks", [(100, 2), (64, 2), (90, 1)])
def test_build_matches_reference(n, codebooks):
    """n = 100 in lists of 8: 16 lists, 12.5 of them filled — lists 13-15
    are empty.  ``perm`` and ``codes`` are equal; the floats within 1e-5."""
    w, _ = _inputs(n, seed=n)
    mine, theirs = _stats(w, codebooks=codebooks)
    assert (mine.num_lists, mine.list_size) == midx.list_dims(n, D, 8) == \
        jmidx.list_dims(n, D, 8)
    np.testing.assert_array_equal(mine.perm.numpy(), np.asarray(theirs.perm))
    np.testing.assert_array_equal(mine.codes.numpy(),
                                  np.asarray(theirs.codes))
    assert mine.perm.dtype == mine.codes.dtype == torch.int32
    for f in ("c1", "c2", "cnt", "wq"):
        _close(getattr(mine, f).numpy(), getattr(theirs, f), msg=f)
    assert int(mine.n_valid) == n


def test_kmeans_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(50, D)).astype(np.float32)
    mask = rng.random(50) < 0.8
    c, a = midx.kmeans(torch.from_numpy(x), 6, 8, torch.from_numpy(mask))
    jc, ja = jax.jit(lambda x_, m_: jmidx.kmeans(x_, 6, 8, m_))(
        jnp.asarray(x), jnp.asarray(mask))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    _close(c.numpy(), jc)


def test_quantized_dots_and_list_log_masses_match_reference():
    w, hs = _inputs(100, seed=2)
    mine, theirs = _stats(w)
    th, jh = torch.from_numpy(hs), jnp.asarray(hs)
    _close(midx.quantized_dots(mine, th).numpy(),
           jmidx.quantized_dots(theirs, jh), atol=1e-5)
    got = midx.list_log_masses(mine, K, th).numpy()
    want = np.asarray(jax.jit(lambda s, h_: jmidx.list_log_masses(
        s, JK, h_, use_kernels=False))(theirs, jh))
    assert got.shape == want.shape == (3, 16)
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all()
    assert not finite[:, 13:].any()  # the empty lists
    _close(got[finite], want[finite])


def test_member_log_scores_match_reference():
    w, hs = _inputs(100, seed=3)
    mine, theirs = _stats(w)
    lists = np.array([[0, 12, 12, 5], [3, 12, 1, 0], [7, 9, 12, 2]])
    got = midx.member_log_scores(mine, K, torch.from_numpy(hs),
                                 torch.from_numpy(lists)).numpy()
    want = np.asarray(jax.jit(lambda s, h_, l_: jmidx.member_log_scores(
        s, JK, h_, l_, use_kernels=False))(theirs, jnp.asarray(hs),
                                           jnp.asarray(lists)))
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all() and (~finite).any()
    _close(got[finite], want[finite])


def test_stages_refuse_other_kernels():
    """Both stages score through the quadratic kernel's CUDA kernels; any
    other kernel raises instead of taking a path the card never runs."""
    w, hs = _inputs(100, seed=3)
    mine = midx.build(torch.from_numpy(w), codewords=4, list_size=8)
    quartic, th = kf.quartic_kernel(), torch.from_numpy(hs)
    with pytest.raises(ValueError, match="quadratic"):
        midx.list_log_masses(mine, quartic, th)
    with pytest.raises(ValueError, match="quadratic"):
        midx.member_log_scores(mine, quartic, th,
                               torch.zeros((3, 2), dtype=torch.int64))


@pytest.mark.parametrize("t,k,p", [(16, 4, 16), (37, 5, 100), (1, 3, 9),
                                   (130, 8, 136)])
def test_ops_midx_list_masses_matches_jax(t, k, p):
    """Ragged query and list counts (off the reference's 128-wide tiles),
    with the last lists empty: their masses are exactly 0."""
    rng = np.random.default_rng(t + p)
    h = (rng.normal(size=(t, D)) * 0.5).astype(np.float32)
    c1 = rng.normal(size=(k, D)).astype(np.float32)
    c2 = (rng.normal(size=(k, D)) * 0.3).astype(np.float32)
    codes = rng.integers(0, k, (p, 2)).astype(np.int32)
    n_rows = (p * 8 * 3) // 5  # the last two fifths of the lists are empty
    cnt = np.clip(n_rows - np.arange(p) * 8.0, 0, 8).astype(np.float32)
    want = np.asarray(jops.midx_list_masses(*map(jnp.asarray, (
        h, c1, c2, codes, cnt)), alpha=100.0))
    args = tuple(map(torch.from_numpy, (h, c1, c2, codes, cnt)))
    for got in (ops.midx_list_masses(*args, alpha=100.0),
                ref.midx_list_masses_ref(*args, 100.0)):
        assert got.shape == (t, p)
        _close(got.numpy(), want)
        assert float(got[:, -1].abs().max()) == 0.0


@pytest.mark.parametrize("g,lsize,d", [(16, 8, 16), (37, 5, 12),
                                       (1, 16, 8), (130, 3, 7)])
def test_ops_midx_member_scores_matches_jax(g, lsize, d):
    rng = np.random.default_rng(g * 10 + d)
    h = (rng.normal(size=(g, d)) * 0.5).astype(np.float32)
    rows = (rng.normal(size=(g, lsize, d)) * 0.5).astype(np.float32)
    rows[:, -1] = 0.0  # a padding row scores exactly 1
    want = np.asarray(jops.midx_member_scores(jnp.asarray(h),
                                              jnp.asarray(rows), alpha=100.0))
    th, tr = torch.from_numpy(h), torch.from_numpy(rows)
    for got in (ops.midx_member_scores(th, tr, alpha=100.0),
                ref.midx_member_scores_ref(th, tr, 100.0)):
        assert got.shape == (g, lsize)
        _close(got.numpy(), want)
        assert (got[:, -1] == 1.0).all()


@pytest.mark.parametrize("n", [100, 64])
def test_all_class_logq_matches_reference(n):
    w, hs = _inputs(n, seed=4)
    mine, theirs = _stats(w)
    for h in hs:
        got = midx.all_class_logq(mine, K, torch.from_numpy(h)).numpy()
        want = np.asarray(_jall_class_logq(theirs, jnp.asarray(h)))
        assert got.shape == want.shape == (mine.n_pad,)
        finite = np.isfinite(want)
        assert (np.isfinite(got) == finite).all()
        assert finite[:n].all() and not finite[n:].any()
        _close(got[finite], want[finite], atol=1e-5)


def test_draw_logq_equals_all_class_logq():
    w, hs = _inputs(100, seed=5)
    mine, _ = _stats(w)
    ids, logq = midx.sample_batch(mine, K, torch.from_numpy(hs), 500,
                                  torch.Generator().manual_seed(0))
    assert ids.shape == logq.shape == (3, 500) and ids.dtype == torch.int64
    for t in range(3):
        oracle = midx.all_class_logq(mine, K, torch.from_numpy(hs[t]))
        _close(logq[t].numpy(), oracle[ids[t]].numpy(), atol=1e-5)
    one, lq = midx.sample(mine, K, torch.from_numpy(hs[0]), 5,
                          torch.Generator())
    assert one.shape == lq.shape == (5,)


def test_draws_pass_the_chi_square_gate_against_reference():
    """60,000 draws per query at N = 64 (8 lists of 8, 4 codewords)."""
    w, hs = _inputs(64, seed=6)
    mine, theirs = _stats(w)
    ids, _ = midx.sample_batch(mine, K, torch.from_numpy(hs[:2]), 60_000,
                               torch.Generator().manual_seed(0))
    for t in range(2):
        q = np.exp(np.asarray(_jall_class_logq(theirs, jnp.asarray(hs[t]))))
        _check_against(ids[t].numpy(), q / q.sum(), f"port midx q{t}")


def test_empty_last_lists_are_never_drawn():
    """n = 100 in lists of 8: lists 13-15 are empty.  The reference's
    inverse-CDF stage 1 maps a uniform past its fp32 cdf[-1] onto the LAST
    list (empty here); the port's multinomial never draws a zero-mass list,
    so no id reaches the padding and no logq is NaN."""
    w, hs = _inputs(100, seed=7)
    mine, theirs = _stats(w)
    logits = jmidx.list_log_masses(theirs, JK, jnp.asarray(hs),
                                   use_kernels=False)
    cdf = jnp.cumsum(jax.nn.softmax(logits, axis=-1), axis=-1)
    past = jax.vmap(lambda c: jnp.searchsorted(c, 2.0, side="right"))(cdf)
    # any uniform above cdf[-1] lands where a uniform of 2.0 does: clipped
    # to the last list, which is empty
    slot = np.minimum(np.asarray(past), 15)
    assert (np.asarray(theirs.cnt)[slot] == 0).all()
    mine_ids, mine_logq = midx.sample_batch(
        mine, K, torch.from_numpy(hs), 20_000,
        torch.Generator().manual_seed(1))
    assert int(mine_ids.max()) < 100
    assert torch.isfinite(mine_logq).all()
    slots = categorical_rows(jax.random.PRNGKey(0), logits, 4)
    assert slots.shape == (3, 4)  # the reference's draw, for the record


def test_midx_sampler_protocol_round_trip():
    """build_stats -> hydrate is ``midx.build``; the cfg's codewords and
    list size are taken; sampling through the protocol stays below
    n_valid."""
    from repro_torch.configs import get_config

    cfg = get_config("youtube-dnn").reduced(vocab_size=200, sampler="midx")
    smp = samplers.sampler_from_config(cfg)
    assert isinstance(smp, samplers.MIDXSampler)
    assert (smp.codewords, smp.codebooks, smp.list_size) == (8, 2, 32)
    w, hs = _inputs(200, seed=8)
    gen = torch.Generator().manual_seed(0)
    state = smp.init_state(gen, torch.from_numpy(w))
    assert state.const == {}
    assert set(state.stats) == {"c1", "c2", "codes", "cnt", "perm", "wq"}
    runtime = smp.island_runtime(state, torch.from_numpy(w), 200)
    direct = midx.build(torch.from_numpy(w), codewords=8, list_size=32)
    assert torch.equal(runtime.perm, direct.perm)
    ids, logq = smp.sample_batch(runtime, torch.from_numpy(hs), 8, gen)
    assert ids.shape == (3, 8) and int(ids.max()) < 200
    _close(logq[2].numpy(), smp.all_class_logq(
        runtime, torch.from_numpy(hs[2]))[ids[2]].numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="midx_codebooks"):
        get_config("youtube-dnn").reduced(
            sampler="midx", midx_codebooks=3).validate()
