"""The port's gradient-bias check (``repro_torch.bench.bias_vs_samples``)
against the JAX package's ``benchmarks/bias_vs_samples.py::grad_bias``, on
the CPU, at the reference's own arguments (n 256, d 12, 4 queries, 8,000
repetitions, m 16 and 64, rff D 512, a tapas pool of 128).

The problem is the reference's: its w, queries and labels drawn by
``jax.random`` from PRNGKey(0) and rff's directions from fold_in(key, 2),
passed across.  Then:

  * each family's q vector equals the reference's within 1e-4;
  * the batched Monte-Carlo sums equal ``sampled_softmax_grad_wrt_logits``
    (the reference's and the port's) repetition by repetition;
  * every row is within Monte-Carlo noise of the reference's row computed
    live here on the same problem: a row's bias_linf is max_i |b_i + e_i|
    with e_i the noise of class i's mean, so two runs differ by at most
    max_i |e_i| + max_i |e'_i|.  With ``mc_se_linf`` the largest standard
    error, a bound of 4.5 standard errors a run (P(|Z| > 4.5) * 256 classes
    < 2e-3) gives 4.5 x (1 + sqrt(8000 / r)) x mc_se_linf where the
    reference runs r repetitions: 2,000 in the dense section (13.5 x), 1,000
    in the real-draw one (17.2 x), to keep the file's time down;
  * the rows keep the order of ``BENCH_grad_bias.json`` where it is wider
    than that noise.

``BENCH_grad_bias.json`` itself is not the oracle: the reference run live on
this tree's jax draws another w from PRNGKey(0) than the one the file was
made with (its uniform row at m = 16 is 0.24 here, 0.116 in the file)."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_fns as jkf
from repro.core import sampled_softmax as jss
from repro.core import samplers as jsamplers
from repro_torch.bench import bias_vs_samples as gb
from repro_torch.core.sampled_softmax import sampled_softmax_grad_wrt_logits

torch.set_num_threads(1)

N, D, Q, REPS, MS, RFF_DIM = 256, 12, 4, 8000, (16, 64), 512
#: the reference's repetitions here, dense and real-draw sections
DENSE_REF_REPS, REAL_REF_REPS = 2000, 1000
KEY = jax.random.PRNGKey(0)


def _reference_problem():
    w = jax.random.normal(KEY, (N, D)) * 0.5
    hs = jax.random.normal(jax.random.fold_in(KEY, 1), (Q, D)) * 1.2
    labels = [int(jax.random.categorical(jax.random.fold_in(KEY, 10 + t),
                                         w @ hs[t])) for t in range(Q)]
    omega = jkf.rff_directions(jax.random.fold_in(KEY, 2), RFF_DIM, D)
    return w, hs, labels, omega


W, HS, LABELS, OMEGA = _reference_problem()
PROBLEM = {"w": torch.from_numpy(np.array(W)),
           "hs": torch.from_numpy(np.array(HS)),
           "labels": torch.tensor(LABELS),
           "omega": torch.from_numpy(np.array(OMEGA))}


@functools.lru_cache(maxsize=None)
def _ref_logq_all(name):
    """The reference's ``logq_for`` of ``grad_bias``, live, for every
    query: (Q, n)."""
    if name == "uniform":
        return np.full((Q, N), -np.log(N), np.float32)
    if name in ("rff", "midx"):
        smp = (jsamplers.make_sampler("rff", dim=RFF_DIM, leaf_size=16)
               if name == "rff" else
               jsamplers.make_sampler("midx", codewords=8, list_size=16))
        st = jax.jit(smp.init)(jax.random.fold_in(KEY, 2), W)
        fn = smp.all_class_logq
    else:
        smp = jsamplers.make_sampler(name)
        st, fn = smp.init(None, W), smp.logq_all
    return np.asarray(jax.jit(jax.vmap(lambda h: fn(st, h)))(HS))[:, :N]


@pytest.fixture(scope="module")
def port_rows():
    rows = gb.grad_bias(device="cpu", problem=PROBLEM, quiet=True)
    return {(r["sampler"], r["m"]): r for r in rows}


@pytest.mark.parametrize("name", gb.GRAD_BIAS_SAMPLERS)
def test_family_q_vectors_equal_the_reference(name):
    for t in range(Q):
        got = gb.family_logq(name, PROBLEM["w"], PROBLEM["hs"][t],
                             omega=PROBLEM["omega"], rff_dim=RFF_DIM)
        want = _ref_logq_all(name)[t]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_mc_sums_equal_eq5_per_repetition():
    """The batched sums against the eq. 5 estimator one repetition at a
    time, both packages', with hits collided and masked or not."""
    o = PROBLEM["w"] @ PROBLEM["hs"][0]
    label = torch.tensor(LABELS[0])
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, N, (6, 16), generator=gen)
    ids[0, 3] = ids[2, 5] = label
    ids[1, 4] = ids[1, 7]
    logq = -torch.rand((6, 16), generator=gen) - 5.0
    for mask in (False, True):
        s1, s2 = gb.mc_grad_sums(o, label, ids, logq, mask_hits=mask)
        per = [sampled_softmax_grad_wrt_logits(o, label, ids[r], logq[r],
                                               n=N, mask_hits=mask)
               for r in range(6)]
        ref = [np.asarray(jss.sampled_softmax_grad_wrt_logits(
            jnp.asarray(o.numpy()), jnp.asarray(LABELS[0]),
            jnp.asarray(ids[r].numpy()), jnp.asarray(logq[r].numpy()),
            n=N, mask_hits=mask)) for r in range(6)]
        np.testing.assert_allclose(s1.numpy(), sum(p.double() for p in per),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(s2.numpy(),
                                   sum(p.double() ** 2 for p in per),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(s1.numpy(), np.sum(ref, axis=0),
                                   rtol=1e-5, atol=1e-5)


def _ref_dense_rows():
    """The reference's dense section, live, at DENSE_REF_REPS: its own
    eq. 5 under a jitted vmap over the repetitions, one compile per m."""
    fns = {m: jax.jit(lambda k, o, label, logq, m=m: jax.vmap(
        lambda kk: jss.sampled_softmax_grad_wrt_logits(
            o, label, (ids := jax.random.categorical(kk, logq, shape=(m,))),
            logq[ids], n=N))(jax.random.split(k, DENSE_REF_REPS)).mean(0))
        for m in MS}
    rows = {}
    for name in gb.GRAD_BIAS_SAMPLERS:
        for m in MS:
            linf = []
            for t in range(Q):
                o = W @ HS[t]
                label = jnp.asarray(LABELS[t])
                full = jss.full_softmax_grad_wrt_logits(o[None],
                                                        label[None])[0]
                logq = jnp.where(jnp.arange(N) == label, -jnp.inf,
                                 _ref_logq_all(name)[t])
                logq = logq - jax.nn.logsumexp(logq)
                est = fns[m](jax.random.PRNGKey(100 + t), o, label, logq)
                linf.append(float(jnp.abs(est - full).max()))
            rows[(name, m)] = float(np.mean(linf))
    return rows


def _ref_real_rows():
    """The reference's real-draw section, live, at REAL_REF_REPS."""
    base = jsamplers.make_sampler("block-quadratic-shared", block_size=32)
    tap = jsamplers.make_sampler("tapas", base=base, pool=128)
    rows = {}
    for name, smp in (("block-quadratic-shared", base), ("tapas", tap)):
        st = smp.init(jax.random.fold_in(KEY, 2), W)
        for m in MS:
            def one(k, h, o, label, m=m, smp=smp, st=st):
                if name == "tapas":
                    ids, logq = smp.sample(st, h, m, k)
                else:
                    ids, logq = smp.sample_batch(st, h[None, :], m, k)
                return jss.sampled_softmax_grad_wrt_logits(
                    o, label, ids, logq, n=N, mask_hits=True)
            fn = jax.jit(lambda ks, h, o, label, one=one: jax.vmap(
                lambda k: one(k, h, o, label))(ks).mean(0))
            linf = []
            for t in range(Q):
                o = W @ HS[t]
                label = jnp.asarray(LABELS[t])
                full = jss.full_softmax_grad_wrt_logits(o[None],
                                                        label[None])[0]
                est = fn(jax.random.split(jax.random.PRNGKey(100 + t),
                                          REAL_REF_REPS), HS[t], o, label)
                linf.append(float(jnp.abs(est - full).max()))
            rows[(name, m)] = float(np.mean(linf))
    return rows


def test_rows_within_noise_of_the_live_reference(port_rows):
    want = _ref_dense_rows()
    want_real = _ref_real_rows()
    k_dense = 4.5 * (1 + math.sqrt(REPS / DENSE_REF_REPS))
    k_real = 4.5 * (1 + math.sqrt(REPS / REAL_REF_REPS))
    for key, row in port_rows.items():
        if key in want:
            ref, k = want[key], k_dense
        else:
            ref, k = want_real[key], k_real
        assert abs(row["bias_linf"] - ref) <= k * row["mc_se_linf"], (
            key, row, ref)
    assert len(port_rows) == len(want) + len(want_real) == 14


def test_rows_keep_the_bench_order(port_rows):
    """``BENCH_grad_bias.json``'s order at each m, where its gaps are wider
    than the noise: uniform > midx > quadratic-oracle > rff > softmax, and
    block-quadratic-shared > tapas."""
    for m in MS:
        b = {name: port_rows[(name, m)]["bias_linf"]
             for name in gb.GRAD_BIAS_SAMPLERS + ["block-quadratic-shared",
                                                  "tapas"]}
        assert b["uniform"] > b["midx"] > b["quadratic-oracle"] > b["rff"] \
            > b["softmax"], (m, b)
        assert b["block-quadratic-shared"] > b["tapas"], (m, b)
        for row in port_rows.values():
            assert set(row) == {"sampler", "m", "bias_linf", "bias_l2",
                                "mc_se_linf"}
