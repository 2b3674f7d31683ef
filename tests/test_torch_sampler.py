"""The port's two-level block sampler, kernel functions and sampler registry
against the JAX package, on the CPU.

Deterministic parts are compared on the same numpy inputs: block statistics
within 1e-6 and ``all_class_logq`` within 1e-5 (fp32 sums in other
orders).  Draws come from ``torch.Generator``s, not ``jax.random``, so they
are held to the reference's distribution by the chi-square/TV gate of
``tests/test_sampler_stats.py``, and their ``logq`` to the port's own
all-class oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import blocks as jblocks
from repro.core import kernel_fns as jkf
from repro.core import samplers as jsamplers
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core import blocks, samplers
from repro_torch.core import kernel_fns as kf
from test_sampler_stats import _check_against

torch.set_num_threads(1)

D = 12
KERNELS = {"quadratic": (kf.quadratic_kernel(100.0),
                         jkf.quadratic_kernel(100.0)),
           "quartic": (kf.quartic_kernel(1.0), jkf.quartic_kernel(1.0))}


def _table(n, d=D, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n, d)) * scale).astype(np.float32),
            rng.normal(size=(3, d)).astype(np.float32))


def _stats(w, block, proj=None):
    mine = blocks.build(torch.from_numpy(w), block,
                        None if proj is None else torch.from_numpy(proj))
    theirs = jblocks.build(jnp.asarray(w), block,
                           None if proj is None else jnp.asarray(proj))
    return mine, theirs


@pytest.mark.parametrize("n,block,rank", [(64, 16, None), (60, 16, None),
                                          (100, 32, 8)])
def test_build_matches_reference(n, block, rank):
    """z, cnt and wq of ``blocks.build`` (through ``ops.zstats``), with
    padding rows in the last block and an optional JL projection."""
    w, _ = _table(n)
    proj = None if rank is None else (np.random.default_rng(1).normal(
        size=(rank, D)) / np.sqrt(rank)).astype(np.float32)
    mine, theirs = _stats(w, block, proj)
    for f in ("z", "cnt", "wq"):
        np.testing.assert_allclose(getattr(mine, f).numpy(),
                                   np.asarray(getattr(theirs, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert int(mine.n_valid) == n
    assert (mine.n_blocks, mine.block_size, mine.n_pad) == \
        (theirs.n_blocks, theirs.block_size, theirs.n_pad)


@pytest.mark.parametrize("kernel", ["quadratic", "quartic"])
@pytest.mark.parametrize("n", [64, 60])
def test_all_class_logq_matches_reference(kernel, n):
    w, hs = _table(n, seed=2)
    mine, theirs = _stats(w, 16)
    k, jk = KERNELS[kernel]
    for h in hs:
        got = blocks.all_class_logq(mine, k, torch.from_numpy(h)).numpy()
        want = np.asarray(jblocks.all_class_logq(theirs, jk, jnp.asarray(h)))
        assert got.shape == (64,)
        np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=1e-5,
                                   atol=1e-7)
        finite = np.isfinite(want)
        assert (np.isfinite(got) == finite).all()
        np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5,
                                   atol=1e-5)
    got = blocks.all_class_logq(mine, KERNELS["quadratic"][0],
                                torch.from_numpy(hs), shared=True).numpy()
    want = np.asarray(jblocks.all_class_logq(
        theirs, KERNELS["quadratic"][1], jnp.asarray(hs), shared=True))
    np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("kernel", ["quadratic", "quartic"])
def test_draw_logq_equals_all_class_logq(kernel):
    """Every draw's reported logq is the all-class oracle's at its id
    (the quartic kernel takes the plain leaf step, the quadratic one the
    kernels' plain versions here)."""
    w, hs = _table(60, seed=3)
    stats, _ = _stats(w, 16)
    k, _ = KERNELS[kernel]
    ids, logq = blocks.sample(stats, k, torch.from_numpy(hs), 400,
                              torch.Generator().manual_seed(0))
    assert ids.shape == logq.shape == (3, 400)
    assert ids.dtype == torch.int64 and logq.dtype == torch.float32
    for t in range(3):
        oracle = blocks.all_class_logq(stats, k, torch.from_numpy(hs[t]))
        np.testing.assert_allclose(logq[t].numpy(), oracle[ids[t]].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_draws_pass_the_chi_square_gate_against_reference():
    """60,000 draws per query at N = 64 (four blocks of 16), fixed seed:
    the port's empirical frequencies against exp of the REFERENCE's
    ``all_class_logq``."""
    w, hs = _table(64, seed=4)
    mine, theirs = _stats(w, 16)
    k, jk = KERNELS["quadratic"]
    ids, _ = blocks.sample(mine, k, torch.from_numpy(hs[:2]), 60_000,
                           torch.Generator().manual_seed(0))
    for t in range(2):
        q = np.exp(np.asarray(jblocks.all_class_logq(theirs, jk,
                                                     jnp.asarray(hs[t]))))
        _check_against(ids[t].numpy(), q / q.sum(), f"port block q{t}")


def test_padding_ids_are_never_drawn():
    """n = 60 in blocks of 16: the last block holds 4 zero padding rows,
    which the leaf kernel scores 1 and the n_valid mask zeroes."""
    w, hs = _table(60, seed=5)
    stats, _ = _stats(w, 16)
    ids, logq = blocks.sample(stats, KERNELS["quadratic"][0],
                              torch.from_numpy(hs), 20_000,
                              torch.Generator().manual_seed(1))
    assert int(ids.max()) < 60 and torch.isfinite(logq).all()
    assert int((ids >= 48).sum()) > 0  # the last block is drawn at all


def test_kernel_functions_match_reference():
    rng = np.random.default_rng(6)
    w = rng.normal(size=(10, 5)).astype(np.float32)
    h = rng.normal(size=(5,)).astype(np.float32)
    hh = rng.normal(size=(5, 5)).astype(np.float32)
    z, cnt = kf.gram_stats(torch.from_numpy(w))
    jz, jcnt = jkf.gram_stats(jnp.asarray(w))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-6)
    assert float(cnt) == float(jcnt) == 10
    for name in ("quadratic", "quartic"):
        k, jk = KERNELS[name]
        np.testing.assert_allclose(
            k.pair_scores(torch.from_numpy(h), torch.from_numpy(w)).numpy(),
            np.asarray(jk.pair_scores(jnp.asarray(h), jnp.asarray(w))),
            rtol=1e-5)
        assert (k.name, k.degree, k.alpha) == (jk.name, jk.degree, jk.alpha)
    k, jk = KERNELS["quadratic"]
    np.testing.assert_allclose(
        k.phi(torch.from_numpy(h)).numpy(), np.asarray(jk.phi(jnp.asarray(h))),
        rtol=1e-6)
    np.testing.assert_allclose(
        float(kf.gram_set_mass(k, z, cnt, torch.from_numpy(h))),
        float(jkf.gram_set_mass(jk, jz, jcnt, jnp.asarray(h))), rtol=1e-5)
    np.testing.assert_allclose(
        float(kf.gram_set_mass_batch(k, z, cnt, torch.from_numpy(hh), 3.0)),
        float(jkf.gram_set_mass_batch(jk, jz, jcnt, jnp.asarray(hh), 3.0)),
        rtol=1e-5)
    with pytest.raises(NotImplementedError):
        KERNELS["quartic"][0].phi(torch.from_numpy(h))


def test_registry_lists_the_ported_families():
    assert samplers.sampler_names() == ["block-quadratic",
                                        "block-quadratic-shared", "uniform"]
    assert set(samplers.sampler_names()) < set(jsamplers.sampler_names())
    with pytest.raises(NotImplementedError, match="ROADMAP.md A12"):
        samplers.make_sampler("rff")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        samplers.make_sampler("tree-quadratic")
    with pytest.raises(KeyError, match="unknown sampler"):
        samplers.make_sampler("block-quadratc")
    with pytest.raises(ValueError, match="Sampler protocol"):
        samplers.make_sampler("bigram")
    shared = samplers.make_sampler("block-quadratic-shared")
    assert shared.shares_negatives and shared.carries_state
    with pytest.raises(NotImplementedError, match="shared"):
        shared.sample_batch({"stats": None, "proj": None},
                            torch.zeros(2, 4), 3, torch.Generator())


@pytest.mark.parametrize("tp", [1, 2])
def test_state_shapes_match_reference(tp):
    cfg = get_config("youtube-dnn").reduced(vocab_size=500)
    jcfg = jget_config("youtube-dnn").reduced(vocab_size=500)
    mine = samplers.sampler_from_config(cfg).state_shapes(cfg, tp)
    theirs = jsamplers.sampler_from_config(jcfg).state_shapes(jcfg, tp)
    for part in ("stats", "const"):
        got = {k: tuple(v.shape) for k, v in getattr(mine, part).items()}
        want = {k: tuple(v.shape) for k, v in getattr(theirs, part).items()}
        assert got == want
    assert all(v.device.type == "meta" for v in mine.stats.values())


def test_block_sampler_protocol_round_trip():
    """init_state -> hydrate -> sample_batch, the train step's path, gives
    the build's statistics and draws below n_valid."""
    cfg = get_config("youtube-dnn").reduced(vocab_size=200)
    smp = samplers.sampler_from_config(cfg)
    assert isinstance(smp, samplers.BlockSampler)
    assert (smp.block_size, smp.kernel.alpha) == (32, 100.0)
    assert smp.supports_head_loss()
    w, _ = _table(200, d=16, seed=7)
    gen = torch.Generator().manual_seed(0)
    state = smp.init_state(gen, torch.from_numpy(w))
    assert state.const == {} and set(state.stats) == {"z", "cnt", "wq"}
    runtime = smp.island_runtime(state, torch.from_numpy(w), 200)
    ref = blocks.build(torch.from_numpy(w), 32)
    np.testing.assert_array_equal(runtime["stats"].z.numpy(), ref.z.numpy())
    ids, logq = smp.sample_batch(runtime, torch.ones(4, 16), 8, gen)
    assert ids.shape == (4, 8) and int(ids.max()) < 200
    assert not any(kernels.launch_counts()[k]
                   for k in ("zstats", "block_scores", "leaf_scores"))


def test_uniform_sampler_draws_valid_rows():
    smp = samplers.make_sampler("uniform")
    assert not smp.carries_state and smp.supports_head_loss()
    state = smp.island_runtime(samplers.empty_state(), torch.zeros(50, 4),
                               37)
    ids, logq = smp.sample_batch(state, torch.zeros(3, 4), 500,
                                 torch.Generator().manual_seed(0))
    assert ids.shape == (3, 500) and 0 <= int(ids.min()) \
        and int(ids.max()) < 37
    np.testing.assert_allclose(logq.numpy(), -np.log(37.0), rtol=1e-6)
    one, lq = smp.sample(state, torch.zeros(4), 5, torch.Generator())
    assert one.shape == lq.shape == (5,)
