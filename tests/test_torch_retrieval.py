"""The port's retrieval stack (hierarchy, pc_bisect_perm, serving index,
beam decode) against the JAX package's, on the same numpy inputs.

Tolerances: Gram sums, centroids and radii to rtol 1e-5 (fp32 sums in other
orders); the max-norm bound to 1 ulp (rtol 1e-6: the row-norm sum runs in
another order); counts, the leaf table and the permutation exactly;
eigenvalues to 1e-4 relative and the spectral bound compared by value
(eigenvectors are defined only up to sign); decode ids exactly and logits to
1e-5.  One table shape serves most tests, and the JAX side runs under
``jax.jit``: compiling each op of an eager call anew dominated these tests'
time.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import hierarchy as jhier
from repro.core import midx as jmidx
from repro.serve import engine as jengine
from repro.serve import retrieval as jret
from repro.sharding.rules import local_ctx
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import hierarchy, midx
from repro_torch.serve import engine, retrieval
from repro_torch.utils.misc import top_k

torch.set_num_threads(1)

CTX = local_ctx()
N, D, VOCAB, LEAF = 256, 16, 250, 8  # 32 leaves, 6 padding rows


def _table(seed, n=N, d=D, scale=0.3):
    return (np.random.default_rng(seed).normal(size=(n, d)) * scale
            ).astype(np.float32)


_jbuild = {c: jax.jit(functools.partial(jret.build_index, leaf_size=LEAF,
                                         vocab_size=VOCAB, cluster=c))
           for c in (False, True)}
_jdecode = jax.jit(jret.decode_topk, static_argnums=(2, 3),
                   static_argnames=("gram_cap",))
_JAX_INDEXES = {}


def _jax_index(cluster: bool):
    """The reference index over the shared table, built once per module."""
    if cluster not in _JAX_INDEXES:
        _JAX_INDEXES[cluster] = _jbuild[cluster](jnp.asarray(_table(0)))
    return _JAX_INDEXES[cluster]


def _port_index(jidx):
    fields = {f: np.asarray(getattr(jidx, f))
              for f in retrieval.RetrievalIndex.TENSORS}
    fields.update(n=jidx.n, tp=jidx.tp, v_shard=jidx.v_shard)
    return convert.index_from_jax(fields, device="cpu")


@pytest.mark.parametrize("n,leaf,n_valid", [(200, 8, None), (256, 16, 250)])
def test_hierarchy_build_and_heap_match_jax(n, leaf, n_valid):
    w = _table(n, n, D, 1.0)
    js = jax.jit(functools.partial(jhier.build, leaf_size=leaf,
                                   n_valid=n_valid))(jnp.asarray(w))
    ts = hierarchy.build(torch.from_numpy(w), leaf, n_valid=n_valid,
                         full_tree=True)
    assert ts.depth == js.depth and ts.n == js.n
    assert int(ts.n_valid) == int(js.n_valid)
    np.testing.assert_array_equal(ts.wq.numpy(), np.asarray(js.wq))
    for a, b in zip(ts.levels_z, js.levels_z):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    for a, b in zip(ts.levels_cnt, js.levels_cnt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(ts.levels_ub, js.levels_ub):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)

    tz, tc = hierarchy.to_heap(ts)
    jz, jc = jhier.to_heap(js)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    back = hierarchy.from_heap(tz, tc, ts.wq, ts.n_valid, ts.n)
    for a, b in zip(back.levels_z, ts.levels_z):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(back.levels_ub, ts.levels_ub):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_pack_unpack_levels_round_trip():
    levels = [torch.arange(1 << lvl, dtype=torch.float32) for lvl in range(4)]
    heap = hierarchy.pack_levels(levels)
    assert heap.shape[0] == hierarchy.heap_rows(8) == 16
    assert float(heap[-1]) == 0.0
    for a, b in zip(hierarchy.unpack_levels(heap, 3), levels):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("n_valid", [N, VOCAB])
def test_pc_bisect_perm_matches_jax(n_valid):
    """Equal permutations on a seeded table without near-ties, padding
    rows (key +inf) kept as a contiguous, stably ordered suffix."""
    w = _table(3, scale=1.0)
    w[n_valid:] = 0.0
    jp = np.asarray(jax.jit(jmidx.pc_bisect_perm, static_argnums=2)(
        jnp.asarray(w), n_valid, 5))
    tp = midx.pc_bisect_perm(torch.from_numpy(w), n_valid, 5)
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tp.numpy()[n_valid:], np.arange(n_valid, N))


def test_ball_and_spectral_stats_match_jax():
    w = _table(4, scale=1.0)
    w[VOCAB:] = 0.0
    jm, jr = jax.jit(jret.ball_stats, static_argnums=2)(jnp.asarray(w),
                                                         VOCAB, 5)
    tm, tr = retrieval.ball_stats(torch.from_numpy(w), VOCAB, 5)
    for a, b in zip(tm + tr, jm + jr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)

    jz = jax.jit(functools.partial(jhier.build, leaf_size=LEAF,
                                   n_valid=VOCAB))(jnp.asarray(w)).levels_z
    jv, jl = jax.jit(jret.spectral_stats)(jz)
    tv, tl = retrieval.spectral_stats(
        tuple(torch.from_numpy(np.array(z)) for z in jz))
    h = _table(5, 6, scale=1.0)
    for lvl in range(len(jz)):
        lam_t, lam_j = tl[lvl].numpy(), np.asarray(jl[lvl])
        np.testing.assert_allclose(lam_t, lam_j, rtol=1e-4,
                                   atol=1e-4 * np.abs(lam_j).max())
        # the bound sum_i lam_i <h, v_i>^2 is sign-free
        bt = np.einsum("ns,tns->tn", lam_t[:, :-1],
                       np.einsum("nsr,tr->tns", tv[lvl].numpy(), h) ** 2)
        bj = np.einsum("ns,tns->tn", lam_j[:, :-1],
                       np.einsum("nsr,tr->tns", np.asarray(jv[lvl]), h) ** 2)
        np.testing.assert_allclose(bt, bj, rtol=1e-4,
                                   atol=1e-4 * np.abs(bj).max())


@pytest.mark.parametrize("cluster", [False, True])
def test_build_index_matches_jax(cluster):
    jidx = _jax_index(cluster)
    tidx = retrieval.build_index(_table(0), leaf_size=LEAF, cluster=cluster,
                                 vocab_size=VOCAB, device="cpu")
    assert (tidx.n, tidx.tp, tidx.v_shard) == (jidx.n, jidx.tp, jidx.v_shard)
    np.testing.assert_array_equal(tidx.perm.numpy(), np.asarray(jidx.perm))
    np.testing.assert_array_equal(tidx.wq.numpy(), np.asarray(jidx.wq))
    np.testing.assert_array_equal(tidx.cnt.numpy(), np.asarray(jidx.cnt))
    for f in ("z", "mu", "rad"):
        np.testing.assert_allclose(getattr(tidx, f).numpy(),
                                   np.asarray(getattr(jidx, f)), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(tidx.evals.numpy(), np.asarray(jidx.evals),
                               rtol=1e-4, atol=1e-5)
    assert retrieval.scored_classes(tidx, 4) == jret.scored_classes(jidx, 4)


@pytest.mark.parametrize("beam", [None, 4])
@pytest.mark.parametrize("cluster", [False, True])
def test_decode_topk_on_jax_index_matches(cluster, beam):
    """The JAX-built index carried over by index_from_jax decodes to the
    same ids and logits, through the einsum path and through the kernel
    path (the plain versions on the CPU)."""
    h = _table(1, 6, scale=1.0)
    jidx = _jax_index(cluster)
    tidx = _port_index(jidx)
    jids, jlog = _jdecode(jidx, jnp.asarray(h), 10, beam)
    for use_kernels in (False, True):
        ids, logits = retrieval.decode_topk(tidx, torch.from_numpy(h), 10,
                                            beam, use_kernels=use_kernels)
        assert ids.dtype == torch.int32
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                                   rtol=1e-5, atol=1e-5)
    if beam is None:  # full beam is exact: equal to the dense head
        dids, dlog = retrieval.dense_topk(torch.from_numpy(_table(0)),
                                          torch.from_numpy(h), 10,
                                          n_valid=VOCAB)
        np.testing.assert_array_equal(ids.numpy(), dids.numpy())
        np.testing.assert_allclose(logits.numpy(), dlog.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("beam", [None, 4])
def test_gram_bound_descent_matches_jax(beam):
    """gram_cap routes the dense levels through block_scores (the kernel on
    the card); the descent keeps the same leaves as the reference."""
    h = _table(10, 5, scale=1.0)
    jidx = _jax_index(True)
    tidx = _port_index(jidx)
    jids, jlog = _jdecode(jidx, jnp.asarray(h), 5, beam, gram_cap=16)
    ids, logits = retrieval.decode_topk(tidx, torch.from_numpy(h), 5, beam,
                                        use_kernels=True, gram_cap=16)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5)


def test_forced_ties_follow_the_lowest_id_rule():
    """Duplicated rows tie exactly; both packages keep the lowest index
    first (torch.topk promises no order; the port sorts stably)."""
    w = _table(11)
    for a, b in ((3, 200), (10, 11), (40, 120), (41, 249)):
        w[a] *= 10.0 / np.linalg.norm(w[a])  # the largest rows: top-1 ties
        w[b] = w[a]
    h = np.stack([w[3], w[10], w[40], w[41]])
    jd, _ = jret.dense_topk(jnp.asarray(w), jnp.asarray(h), 6,
                            n_valid=VOCAB)
    td, _ = retrieval.dense_topk(torch.from_numpy(w), torch.from_numpy(h), 6,
                                 n_valid=VOCAB)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(td.numpy()[:, :2],
                                  [[3, 200], [10, 11], [40, 120], [41, 249]])
    jidx = _jbuild[True](jnp.asarray(w))
    tidx = _port_index(jidx)
    for beam in (None, 4):
        jids, _ = _jdecode(jidx, jnp.asarray(h), 6, beam)
        ids, _ = retrieval.decode_topk(tidx, torch.from_numpy(h), 6, beam)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    bounds = torch.tensor([[0.0, -np.inf, 1.0, -np.inf, 1.0, -np.inf]])
    _, idx = top_k(bounds, 6)
    assert idx.tolist() == [[2, 4, 0, 1, 3, 5]]


def test_recall_and_engine_decode_match_jax():
    cfg = get_config("youtube-dnn").reduced(vocab_size=VOCAB)
    jcfg = jget_config("youtube-dnn").reduced(vocab_size=VOCAB)
    w = _table(0)
    h = _table(13, 8, scale=1.0)
    jidx = _jax_index(True)
    tidx = _port_index(jidx)
    # recall_at_k's own arithmetic on the reference's decode and dense ids
    jids = np.asarray(_jdecode(jidx, jnp.asarray(h), 10, 4)[0])
    dids = np.asarray(jax.jit(jret.dense_topk, static_argnums=(2, 3))(
        jnp.asarray(w), jnp.asarray(h), 10, VOCAB)[0])
    rec_j = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(jids, dids)])
    rec_t = retrieval.recall_at_k(tidx, torch.from_numpy(w),
                                  torch.from_numpy(h), 10, 4)
    assert rec_t == pytest.approx(rec_j, abs=1e-6)
    jdecode = jax.jit(lambda w, h, index: jengine.decode_topk(
        jcfg, CTX, w, h, 5, index=index, beam=4))
    for index in (None, tidx):
        ids, logits = engine.make_decode_fn(cfg, None, torch.from_numpy(w),
                                            5, beam=4)(index,
                                                       torch.from_numpy(h))
        jids, jlog = jdecode(jnp.asarray(w), jnp.asarray(h),
                             None if index is None else jidx)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                                   rtol=1e-5, atol=1e-5)


def test_unported_paths_raise():
    cfg = get_config("youtube-dnn").reduced()
    w = torch.from_numpy(_table(14, 64, 8))
    h = torch.from_numpy(_table(15, 2, 8))

    @dataclasses.dataclass
    class MeshCtx:
        mesh: object = "mesh"

    with pytest.raises(NotImplementedError):
        engine.decode_topk(cfg, MeshCtx(), w, h, 3)
    with pytest.raises(NotImplementedError):
        retrieval.build_index(w, MeshCtx())

    class QuantizedRetrievalIndex:
        pass

    with pytest.raises(NotImplementedError, match="Quantized"):
        engine.decode_topk(cfg, None, w, h, 3,
                           index=QuantizedRetrievalIndex())
