"""The port's paper tree (``core/tree.py``, the Gram half of
``core/hierarchy.py`` and ``TreeSampler``) against the JAX package, on the
CPU.

Deterministic parts are compared on the same numpy inputs within rtol 1e-5
(fp32 sums in other orders): the tree's levels, the per-level node masses
in their dense (``block_scores``' plain version here) and gathered forms,
the within-leaf log-scores and ``all_class_logq``.  The reference runs
under ``jax.jit`` through its plain paths (its off-TPU default).  Draws
come from ``torch.Generator``s, so they are held to the reference's
``all_class_logq`` by the chi-square/TV gate of
``tests/test_sampler_stats.py``, and their logq to the port's oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hierarchy as jhier
from repro.core import kernel_fns as jkf
from repro.core import tree as jtree
from repro_torch.core import hierarchy, samplers, tree
from repro_torch.core import kernel_fns as kf
from test_sampler_stats import _check_against

torch.set_num_threads(1)

D = 12
K, JK = kf.quadratic_kernel(100.0), jkf.quadratic_kernel(100.0)


def _table(n, d=D, seed=0, scale=0.5, t=3):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n, d)) * scale).astype(np.float32),
            rng.normal(size=(t, d)).astype(np.float32))


def _proj(rank, seed=1):
    if rank is None:
        return None
    return (np.random.default_rng(seed).normal(size=(rank, D))
            / np.sqrt(rank)).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


_jbuild = jax.jit(lambda w, leaf, p: jtree.build(w, JK, leaf, p),
                  static_argnums=1)
_jall_class_logq = jax.jit(lambda s, h, p: jtree.all_class_logq(s, JK, h, p))


def _trees(w, leaf, proj=None):
    mine = tree.build(_t(w), K, leaf, _t(proj))
    return mine, _jbuild(_j(w), leaf, _j(proj))


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("n,leaf,rank", [(64, 8, None), (60, 8, None),
                                         (100, 16, 6)])
def test_tree_build_matches_reference(n, leaf, rank):
    """Every level's Gram sums and counts, and wq, with padding rows in the
    last leaves (n = 60, 100) and an optional projection."""
    w, _ = _table(n)
    mine, theirs = _trees(w, leaf, _proj(rank))
    assert mine.depth == theirs.depth and mine.n == theirs.n
    for lvl in range(mine.depth + 1):
        _close(mine.levels_z[lvl].numpy(), theirs.levels_z[lvl],
               msg=f"z {lvl}")
        _close(mine.levels_cnt[lvl].numpy(), theirs.levels_cnt[lvl],
               msg=f"cnt {lvl}")
    _close(mine.wq.numpy(), theirs.wq, msg="wq")


@pytest.mark.parametrize("n", [64, 60])
def test_level_masses_dense_and_gathered_match_reference(n):
    """Both forms of ``descend``'s per-level masses: the dense (T, nodes)
    table and the per-draw gather at given nodes."""
    w, hs = _table(n, seed=2)
    mine, theirs = _trees(w, 8)
    nodes_rng = np.random.default_rng(3)
    for lvl in range(1, mine.depth + 1):
        z, cnt = mine.levels_z[lvl], mine.levels_cnt[lvl]
        jz, jcnt = theirs.levels_z[lvl], theirs.levels_cnt[lvl]
        dense = hierarchy._mass_table(K, z, cnt, _t(hs))
        jdense = jax.jit(lambda z_, c_, h_: jhier._mass_table(
            JK, z_, c_, h_, False))(jz, jcnt, _j(hs))
        _close(dense.numpy(), jdense, msg=f"dense {lvl}")
        nodes = nodes_rng.integers(0, z.shape[0], (hs.shape[0], 5))
        gathered = hierarchy._gathered_mass(K, z, cnt, _t(hs),
                                            torch.from_numpy(nodes))
        jgathered = jax.jit(lambda z_, c_, h_, i_: jhier._gathered_mass(
            JK, z_, c_, h_, i_))(jz, jcnt, _j(hs), jnp.asarray(nodes))
        _close(gathered.numpy(), jgathered, msg=f"gathered {lvl}")
        np.testing.assert_allclose(
            gathered.numpy(), np.take_along_axis(dense.numpy(), nodes, 1),
            rtol=1e-5)


def test_leaf_logits_match_reference():
    """Within-leaf log-scores at given leaves, the padding of the last
    leaf at -inf on both sides."""
    w, hs = _table(60, seed=4)
    mine, theirs = _trees(w, 8)
    leaves = np.array([[0, 7, 7, 3], [6, 7, 1, 0], [2, 5, 4, 7]])
    got = hierarchy.leaf_logits(mine, K, _t(hs), torch.from_numpy(leaves))
    want = jax.jit(lambda s, h_, i_: jhier.leaf_logits(s, JK, h_, i_, False))(
        theirs, _j(hs), jnp.asarray(leaves))
    want = np.asarray(want)
    assert got.shape == want.shape == (3, 4, 8)
    finite = np.isfinite(want)
    assert (np.isfinite(got.numpy()) == finite).all() and (~finite).any()
    _close(got.numpy()[finite], want[finite])


@pytest.mark.parametrize("n,rank", [(64, None), (60, None), (100, 6)])
def test_all_class_logq_matches_reference(n, rank):
    w, hs = _table(n, seed=5)
    proj = _proj(rank)
    mine, theirs = _trees(w, 8, proj)
    for h in hs:
        got = tree.all_class_logq(mine, K, _t(h), _t(proj)).numpy()
        want = np.asarray(_jall_class_logq(theirs, _j(h), _j(proj)))
        assert got.shape == want.shape == (n,)
        assert np.isfinite(got).all() and np.isfinite(want).all()
        _close(got, want, atol=1e-5)


@pytest.mark.parametrize("rank", [None, 6])
def test_draw_logq_equals_all_class_logq(rank):
    """Every draw's logq is the oracle's at its id (the eq. 2 exactness
    contract), and no id reaches the padding rows."""
    w, hs = _table(60, seed=6)
    proj = _proj(rank)
    stats = tree.build(_t(w), K, 8, _t(proj))
    ids, logq = tree.sample_batch(stats, K, _t(hs), 500,
                                  torch.Generator().manual_seed(0), _t(proj))
    assert ids.shape == logq.shape == (3, 500)
    assert ids.dtype == torch.int64 and int(ids.max()) < 60
    for t in range(3):
        oracle = tree.all_class_logq(stats, K, _t(hs[t]), _t(proj))
        _close(logq[t].numpy(), oracle[ids[t]].numpy(), atol=1e-5)
    one, lq = tree.sample(stats, K, _t(hs[0]), 7, torch.Generator(),
                          _t(proj))
    assert one.shape == lq.shape == (7,)


def test_draws_pass_the_chi_square_gate_against_reference():
    """60,000 draws per query at N = 64 (8 leaves of 8): the port's
    frequencies against exp of the REFERENCE's ``all_class_logq``."""
    w, hs = _table(64, seed=7)
    mine, theirs = _trees(w, 8)
    ids, _ = tree.sample_batch(mine, K, _t(hs[:2]), 60_000,
                               torch.Generator().manual_seed(0))
    for t in range(2):
        q = np.exp(np.asarray(_jall_class_logq(theirs, jnp.asarray(hs[t]),
                                               None)))
        _check_against(ids[t].numpy(), q / q.sum(), f"port tree q{t}")


def test_dense_cap_zero_gives_identical_draws():
    """The gathered form everywhere (``dense_cap=0``) and the default dense
    tables consume the generator alike: one seed, the same draws."""
    w, hs = _table(60, seed=8)
    stats = tree.build(_t(w), K, 8)
    out = [tree.sample_batch(stats, K, _t(hs), 300,
                             torch.Generator().manual_seed(5), dense_cap=cap)
           for cap in (None, 0)]
    assert torch.equal(out[0][0], out[1][0])
    _close(out[0][1].numpy(), out[1][1].numpy(), atol=1e-5)


def test_padding_only_subtrees_are_never_entered():
    """n = 40 in 8 leaves of 8: leaves 5-7 hold padding only (zero mass),
    so no draw reaches them and every logq is finite."""
    w, hs = _table(40, seed=9)
    stats = tree.build(_t(w), K, 8)
    assert float(stats.levels_cnt[1][1]) == 8.0
    ids, logq = tree.sample_batch(stats, K, _t(hs), 20_000,
                                  torch.Generator().manual_seed(2))
    assert int(ids.max()) < 40 and torch.isfinite(logq).all()
    assert int((ids >= 32).sum()) > 0  # the last live leaf is drawn


def test_tree_sampler_protocol_round_trip():
    """init_state -> heap -> hydrate gives ``tree.build``'s statistics; the
    cfg path takes ``sampler_block`` as the leaf size."""
    from repro_torch.configs import get_config

    cfg = get_config("youtube-dnn").reduced(vocab_size=200,
                                            sampler="tree-quadratic")
    smp = samplers.sampler_from_config(cfg)
    assert isinstance(smp, samplers.TreeSampler)
    assert (smp.leaf_size, smp.kernel.alpha) == (32, 100.0)
    w, hs = _table(200, d=16, seed=10)
    gen = torch.Generator().manual_seed(0)
    state = smp.init_state(gen, _t(w))
    assert set(state.stats) == {"z", "cnt", "wq"} and state.const == {}
    runtime = smp.island_runtime(state, _t(w), 200)
    ref = tree.build(_t(w), smp.kernel, 32)
    for a, b in zip(runtime["stats"].levels_z, ref.levels_z):
        assert torch.equal(a, b)
    ids, logq = smp.sample_batch(runtime, _t(hs), 8, gen)
    assert ids.shape == (3, 8) and int(ids.max()) < 200
    _close(logq[0].numpy(),
           smp.all_class_logq(runtime, _t(hs[0]))[ids[0]].numpy(), atol=1e-5)


@pytest.mark.parametrize("n,rank", [(100, None), (300, 6), (5, None)])
def test_default_leaf_size_is_shared_by_build_and_sampler(n, rank):
    """With no leaf size, ``tree.build`` and ``TreeSampler`` take one
    default, ``tree.default_leaf_size`` (the paper's |C| = O(r)), and the
    sampler's statistics are ``tree.build``'s."""
    w, _ = _table(n, seed=11)
    smp = samplers.TreeSampler(kernel=K, proj_rank=rank)
    const = smp.init_const(torch.Generator().manual_seed(0), D)
    proj = const.get("proj")
    want = tree.build(_t(w), K, proj=proj)
    got = smp.build_stats(_t(w), n, const)
    leaf = tree.default_leaf_size(n, rank or D)
    assert leaf == max(2, min(n, rank or D))
    assert want.leaf_size == got["wq"].shape[1] >= leaf
    assert torch.equal(got["wq"], want.wq)
    assert torch.equal(got["z"], hierarchy.to_heap(want)[0])
