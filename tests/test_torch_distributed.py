"""The port's vocab-parallel head (``repro_torch/core/distributed.py``)
against the reference's sharded functions under ``shard_map``.

Both sides take the same seeded numpy inputs on (data, model) meshes of
(1, 2), (2, 2) and (1, 4): the port's on gloo ranks (``torch_mesh_util``),
the reference's in one subprocess over 8 forced host devices.  h and the
labels are split over ``data``, the head's rows over ``model``.

  * deterministic functions (the full-softmax loss, with a bias and abs
    mode; the positive logit; argmax, with a tie across shards; top-k; the
    partition diagnostics) against the reference's sharded results and
    the unsharded ones, fp32 within 1e-5, ids exactly;
  * every sampled estimator at GIVEN negatives, per-example and shared,
    loss and gradients (every head shard summed over ``data``, and h):
    both sides take each shard's ids and local logq from a sampler stub
    defined here; the tapas pool the same way, its slots through the
    patched ``categorical_rows`` of each side;
  * the draws in distribution: each shard's block-quadratic draws against
    its local q by ``tests/test_sampler_stats.py``'s gates, and their
    logq equal to the local logq - log tp.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from torch_mesh_util import MESHES, Ranks, Reference, close, mesh_id, \
    start_meshes

V, D, T, M, POOL, K = 64, 16, 16, 8, 16, 5
V_DRAW = 62  # the draw check's vocab: the last shard padded
DRAWS = 24_000
ESTIMATORS = ("sampled-softmax", "nce", "sampled-logistic")
#: (case, estimator, shared negatives, impl, abs_mode, mask hits)
SAMPLED = [(f"{e}-{'shared' if s else 'pe'}-{impl}-{'abs' if a else 'id'}"
            f"{'' if mask else '-nomask'}", e, s, impl, a, mask)
           for e, s, impl, a, mask in (
               ("sampled-softmax", False, "auto", False, True),
               ("sampled-softmax", False, "auto", True, True),
               ("sampled-softmax", False, "einsum", False, True),
               ("sampled-softmax", False, "auto", False, False),
               ("sampled-softmax", True, "auto", False, True),
               ("nce", False, "auto", True, True),
               ("nce", True, "auto", False, True),
               ("sampled-logistic", False, "auto", False, True),
               ("sampled-logistic", True, "auto", True, True))]
TAPAS = [f"tapas-{e}" for e in ESTIMATORS]


def _inputs() -> dict:
    rng = np.random.default_rng(29)
    w = (rng.normal(size=(V, D)) * 0.3).astype(np.float32)
    w_tie = w.copy()
    w_tie[V - 3] = w_tie[5]  # argmax ties across shards
    out = {"w": w, "w_tie": w_tie,
           "bias": (rng.normal(size=(V,)) * 0.1).astype(np.float32),
           "h": rng.normal(size=(T, D)).astype(np.float32),
           "labels": rng.integers(0, V, size=(T,)).astype(np.int32),
           "meshes": np.asarray(MESHES, np.int32)}
    out["h"][3] = out["h"][4] * 0.0 + 0.5  # constant rows: more ties
    labels = out["labels"]
    for dp, tp in MESHES:
        v_l, t_l, m_l, p_l = V // tp, T // dp, M // tp, POOL // tp
        key = mesh_id((dp, tp))
        ids = rng.integers(0, v_l, size=(T, tp * m_l)).astype(np.int32)
        for t in range(0, T, 3):  # accidental hits on the owning shard
            j = labels[t] // v_l
            ids[t, j * m_l] = labels[t] - j * v_l
        sh = rng.integers(0, v_l, size=(dp, tp * m_l)).astype(np.int32)
        sh[0, (labels[0] // v_l) * m_l] = labels[0] % v_l
        out[f"{key}_ids"] = ids
        out[f"{key}_logq"] = np.log(rng.uniform(
            0.01, 0.2, size=ids.shape)).astype(np.float32)
        out[f"{key}_sids"] = sh
        out[f"{key}_slogq"] = np.log(rng.uniform(
            0.01, 0.2, size=sh.shape)).astype(np.float32)
        pool = rng.integers(0, v_l, size=(dp, tp * p_l)).astype(np.int32)
        pool[:, 1] = pool[:, 0]  # a repeated class: multiplicity 2
        pool[0, 2] = labels[0] % v_l if labels[0] // v_l == 0 else 0
        out[f"{key}_pool"] = pool
        out[f"{key}_lq1"] = np.log(rng.uniform(
            0.005, 0.05, size=pool.shape)).astype(np.float32)
        out[f"{key}_slots"] = rng.integers(
            0, POOL, size=(T, tp * m_l)).astype(np.int32)
        del t_l
    return out


REF_SCRIPT = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from repro.core import distributed as D
from repro.core.estimators import make_estimator
from repro.core.kernel_fns import quadratic_kernel
from repro.core.samplers import BlockSampler
from repro.utils.compat import shard_map

inp = dict(np.load(sys.argv[1]))
out = {}
_SLOTS = {}


class Given:
    """Each shard's given ids and LOCAL logq, whatever the key."""
    two_stage = False

    def __init__(self, shared):
        self.shares_negatives = shared

    def sample_batch(self, state, h, m, key):
        if "slots" in state:
            _SLOTS["v"] = state["slots"]
        ids, logq = state["ids"], state["logq"]
        if self.shares_negatives:
            ids, logq = ids[0], logq[0]
        assert ids.shape[-1] == m, (ids.shape, m)
        return ids, logq


class Tapas:
    two_stage = True

    def __init__(self, pool, tau):
        self.base, self.pool, self.tau = Given(True), pool, tau


D.categorical_rows = lambda key, s, m: _SLOTS["v"]

TAPAS_TAU = 0.7
w, w_tie = jnp.asarray(inp["w"]), jnp.asarray(inp["w_tie"])
bias, h = jnp.asarray(inp["bias"]), jnp.asarray(inp["h"])
labels = jnp.asarray(inp["labels"])
KEY = jax.random.PRNGKey(0)
PD, PM, PDM = P("data"), P("model"), P("data", "model")
blocks = BlockSampler(kernel=quadratic_kernel(3.0), block_size=8)


def grad_case(mesh, f, extra, extra_specs):
    """(per-example loss, dL/dw, dL/dh) of the sum, traced inside the
    mesh's one jit below."""
    sm = shard_map(f, mesh=mesh, check_vma=False,
                   in_specs=(PM, PD, PD) + extra_specs, out_specs=PD)

    def run(w_, h_):
        def total(w2, h2):
            per = sm(w2, h2, labels, *extra)
            return jnp.sum(per), per

        (_, per), (gw, gh) = jax.value_and_grad(
            total, argnums=(0, 1), has_aux=True)(w_, h_)
        return per, gw, gh

    return run


def mesh_cases(mesh):
    """Every case of one mesh: name -> a function of (w, h)."""
    key = mesh_key(mesh)
    cases = {
        "full": grad_case(mesh, lambda wl, hl, ll:
                          D.sharded_full_softmax_loss(wl, hl, ll,
                                                      axis_name="model"),
                          (), ()),
        "full_bias_abs": grad_case(
            mesh, lambda wl, hl, ll, bl: D.sharded_full_softmax_loss(
                wl, hl, ll, axis_name="model", abs_mode=True, bias_local=bl),
            (bias,), (PM,)),
        "pos": grad_case(mesh, lambda wl, hl, ll, bl: D._positive_logit(
            wl, hl, ll, "model", bl), (bias,), (PM,)),
    }
    given = (jnp.asarray(inp[f"{key}_ids"]), jnp.asarray(inp[f"{key}_logq"]),
             jnp.asarray(inp[f"{key}_sids"]),
             jnp.asarray(inp[f"{key}_slogq"]))
    for name, case in zip(inp["sampled_names"], inp["sampled_cases"]):
        est, shared, impl, abs_mode, mask = str(case).split("|")
        shared, abs_mode, mask = shared == "1", abs_mode == "1", mask == "1"

        def f(wl, hl, ll, ids, lq, sids, slq, est=est, smp=Given(shared),
              impl=impl, abs_mode=abs_mode, mask=mask, shared=shared):
            st = {"ids": sids, "logq": slq} if shared else \
                {"ids": ids, "logq": lq}
            if not mask:
                return D.sharded_sampled_softmax_loss(
                    wl, hl, ll, smp, st, 8, KEY, axis_name="model",
                    abs_mode=abs_mode, mask_accidental_hits=False, impl=impl)
            return D.sharded_estimator_loss(
                make_estimator(est), wl, hl, ll, smp, st, 8, KEY,
                axis_name="model", abs_mode=abs_mode, impl=impl)

        cases[str(name)] = grad_case(mesh, f, given, (PDM, PDM, PDM, PDM))
    tap = (jnp.asarray(inp[f"{key}_pool"]), jnp.asarray(inp[f"{key}_lq1"]),
           jnp.asarray(inp[f"{key}_slots"]))
    for est in ("sampled-softmax", "nce", "sampled-logistic"):
        def f(wl, hl, ll, pool, lq1, slots, est=est,
              smp=Tapas(16, TAPAS_TAU)):
            st = {"base": {"ids": pool, "logq": lq1, "slots": slots}}
            return D.sharded_estimator_loss(
                make_estimator(est), wl, hl, ll, smp, st, 8, KEY,
                axis_name="model", abs_mode=True)

        cases[f"tapas-{est}"] = grad_case(mesh, f, tap, (PDM, PDM, PDM))
    return cases


def decodes(mesh):
    """argmax (plain and tied), top-k and the partition diagnostics."""
    out = {}
    for tag, table in (("argmax", w), ("argmax_tie", w_tie)):
        out[tag] = shard_map(
            lambda wl, hl: D.sharded_logits_argmax(wl, hl,
                                                   axis_name="model"),
            mesh=mesh, check_vma=False, in_specs=(PM, PD),
            out_specs=(PD, PD))(table, h)
    out["topk"] = shard_map(
        lambda wl, hl, bl: D.sharded_logits_topk(
            wl, hl, 5, axis_name="model", bias_local=bl),
        mesh=mesh, check_vma=False, in_specs=(PM, PD, PM),
        out_specs=(P("data", None), P("data", None)))(w_tie, h, bias)

    def diag(wl, hl):
        st = blocks.init(KEY, wl)
        return D.sharded_partition_diagnostics(
            st, blocks, hl, axis_name="model")[:, None]

    out["diag"] = shard_map(diag, mesh=mesh, check_vma=False,
                            in_specs=(PM, PD), out_specs=PDM)(w, h)
    return out


def mesh_key(mesh):
    return f"{mesh.shape['data']}x{mesh.shape['model']}"


for dp, tp in [tuple(x) for x in inp["meshes"]]:
    mesh = Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))
    key = mesh_key(mesh)
    cases = mesh_cases(mesh)
    res, dec = jax.jit(lambda w_, h_: (
        {k: f(w_, h_) for k, f in cases.items()}, decodes(mesh)))(w, h)
    for name, triple in res.items():
        for k, v in zip(("loss", "gw", "gh"), triple):
            out[f"{key}_{name}_{k}"] = np.asarray(v)
    for tag in ("argmax", "argmax_tie"):
        out[f"{key}_{tag}_ids"], out[f"{key}_{tag}_best"] = map(
            np.asarray, dec[tag])
    out[f"{key}_topk_ids"], out[f"{key}_topk_vals"] = map(np.asarray,
                                                          dec["topk"])
    out[f"{key}_diag"] = np.asarray(dec["diag"])

np.savez(sys.argv[2], **out)
'''


def _case_code(case) -> str:
    _, est, shared, impl, abs_mode, mask = case
    return "|".join((est, str(int(shared)), impl, str(int(abs_mode)),
                     str(int(mask))))


class _Given:
    """The stub: each shard's given ids and LOCAL logq."""

    two_stage = False

    def __init__(self, shared: bool):
        self.shares_negatives = shared

    def sample_batch(self, state, h, m, gen):
        if "slots" in state:
            _SLOTS["v"] = state["slots"]
        ids, logq = state["ids"], state["logq"]
        if self.shares_negatives:
            ids, logq = ids[0], logq[0]
        assert ids.shape[-1] == m, (ids.shape, m)
        return ids, logq


class _Tapas:
    two_stage = True

    def __init__(self, pool: int, tau: float):
        self.base, self.pool, self.tau = _Given(True), pool, tau


_SLOTS: dict = {}
TAPAS_TAU = 0.7


def _dist_worker(ctx, inp: dict) -> dict:
    from repro_torch.core import distributed as dist
    from repro_torch.core.estimators import make_estimator
    from repro_torch.core.kernel_fns import quadratic_kernel
    from repro_torch.core.samplers import BlockSampler

    dist.categorical_rows = lambda gen, s, m: _SLOTS["v"]
    tp, dp, j, i = ctx.tp, ctx.dp, ctx.model_index, ctx.data_index
    mg, key = ctx.model_group, mesh_id((dp, tp))
    v_l, t_l, m_l, p_l = V // tp, T // dp, M // tp, POOL // tp
    rows, toks = slice(j * v_l, (j + 1) * v_l), slice(i * t_l, (i + 1) * t_l)
    cols = slice(j * m_l, (j + 1) * m_l)
    tt = torch.from_numpy
    w_all, h0 = tt(inp["w"]), tt(inp["h"][toks])
    labels = tt(inp["labels"][toks]).long()
    bias_l = tt(inp["bias"][rows])
    gen = torch.Generator().manual_seed(0)
    out: dict = {}

    def grad_case(name, fn):
        w = w_all[rows].clone().requires_grad_(True)
        h = h0.clone().requires_grad_(True)
        loss = fn(w, dist.replicated(h, mg))
        loss.sum().backward()
        out[name] = (loss.detach().numpy(), w.grad.numpy(), h.grad.numpy())

    grad_case("full", lambda w, h: dist.sharded_full_softmax_loss(
        w, h, labels, group=mg))
    grad_case("full_bias_abs", lambda w, h: dist.sharded_full_softmax_loss(
        w, h, labels, group=mg, abs_mode=True, bias_local=bias_l))
    grad_case("pos", lambda w, h: dist._positive_logit(w, h, labels, mg,
                                                    bias_l))
    for tag, table in (("argmax", "w"), ("argmax_tie", "w_tie")):
        ids, best = dist.sharded_logits_argmax(tt(inp[table][rows]), h0,
                                            group=mg)
        out[tag] = (ids.numpy(), best.numpy())
    ids, vals = dist.sharded_logits_topk(tt(inp["w_tie"][rows]), h0, K,
                                      group=mg, bias_local=bias_l)
    out["topk"] = (ids.numpy(), vals.numpy())
    blocks = BlockSampler(kernel=quadratic_kernel(3.0), block_size=8)
    st = blocks.init_state(gen, w_all[rows])
    out["diag"] = dist.sharded_partition_diagnostics(
        blocks.hydrate(st, v_l), blocks, h0, group=mg).numpy()

    pe = {"ids": tt(inp[f"{key}_ids"][toks, cols]).long(),
          "logq": tt(inp[f"{key}_logq"][toks, cols])}
    sh = {"ids": tt(inp[f"{key}_sids"][i:i + 1, cols]).long(),
          "logq": tt(inp[f"{key}_slogq"][i:i + 1, cols])}
    for name, est, shared, impl, abs_mode, mask in SAMPLED:
        smp, st = _Given(shared), (sh if shared else pe)
        if mask:
            fn = (lambda w, h, est=est, smp=smp, st=st, impl=impl,
                  abs_mode=abs_mode: dist.sharded_estimator_loss(
                      make_estimator(est), w, h, labels, smp, st, M, gen,
                      group=mg, abs_mode=abs_mode, impl=impl))
        else:
            fn = (lambda w, h, smp=smp, st=st, impl=impl, abs_mode=abs_mode:
                  dist.sharded_sampled_softmax_loss(
                      w, h, labels, smp, st, M, gen, group=mg,
                      abs_mode=abs_mode, mask_accidental_hits=False,
                      impl=impl))
        grad_case(name, fn)
    pcols = slice(j * p_l, (j + 1) * p_l)
    tap = {"base": {"ids": tt(inp[f"{key}_pool"][i:i + 1, pcols]).long(),
                    "logq": tt(inp[f"{key}_lq1"][i:i + 1, pcols]),
                    "slots": tt(inp[f"{key}_slots"][toks, cols]).long()}}
    for est in ESTIMATORS:
        grad_case(f"tapas-{est}", lambda w, h, est=est: (
            dist.sharded_estimator_loss(
                make_estimator(est), w, h, labels, _Tapas(POOL, TAPAS_TAU),
                tap, M, gen, group=mg, abs_mode=True)))
    out["collectives"] = _count_fused(dist, w_all[rows], h0, labels, pe, gen,
                                      mg)
    out["draws"] = _draws(dist, ctx)
    out["geometry"] = (dist.axis_size(mg), dist.axis_index(mg),
                       dist.local_vocab_offset(v_l, mg),
                       dist.local_labels(w_all[rows], labels, mg).numpy())
    return out


def _count_fused(dist, w_l, h, labels, pe, gen, mg) -> dict:
    """The collectives of one fused-route sampled-softmax loss, forward
    and backward."""
    w = w_l.clone().requires_grad_(True)
    h = h.clone().requires_grad_(True)
    dist.reset_collective_counts()
    loss = dist.sharded_sampled_softmax_loss(w, dist.replicated(h, mg), labels,
                                          _Given(False), pe, M, gen,
                                          group=mg)
    fwd = dist.collective_counts()
    dist.reset_collective_counts()
    loss.sum().backward()
    return {"forward": fwd, "backward": dist.collective_counts()}


def _draws(dist, ctx) -> dict:
    """Each shard's stratified block-quadratic draws for one query of a
    padded head, with its exact local q."""
    from repro_torch.core.kernel_fns import quadratic_kernel
    from repro_torch.core.samplers import BlockSampler
    from repro_torch.sharding import rules

    tp, j = ctx.tp, ctx.model_index
    rng = np.random.default_rng(31)
    w = torch.from_numpy((rng.normal(size=(V_DRAW, D)) * 0.5).astype(
        np.float32))
    h = torch.from_numpy(rng.normal(size=(1, D)).astype(np.float32))
    v_l = rules.vocab_shard(V_DRAW, tp)
    n_valid = rules.local_n_valid(V_DRAW, v_l, j)
    smp = BlockSampler(kernel=quadratic_kernel(2.0), block_size=4)
    w_l = rules.shard_rows(w, ctx)
    rt = smp.hydrate(smp.init_state(torch.Generator(), w_l,
                                    n_valid=n_valid), n_valid)
    gen = torch.Generator().manual_seed(5 + ctx.data_index)
    ids, logq = dist.sharded_negative_sample(smp, rt, h, tp * DRAWS, gen,
                                          ctx.model_group)
    lq_all = smp.all_class_logq(rt, h[0])
    return {"counts": torch.bincount(ids[0],
                                     minlength=lq_all.shape[0]).numpy(),
            "q": torch.exp(lq_all).numpy(), "n_valid": n_valid,
            "logq_err": float((logq[0] - (lq_all[ids[0]] - math.log(tp)))
                              .abs().max())}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results and each mesh's ranks' results."""
    base = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    ref = Reference(REF_SCRIPT, {
        **inp, "sampled_cases": np.asarray(
            [_case_code(c) for c in SAMPLED]),
        "sampled_names": np.asarray([c[0] for c in SAMPLED])}, base)
    started = start_meshes(_dist_worker, base, inp)
    ranks = {mesh: r.result() for mesh, r in started.items()}
    return inp, ref.result(), ranks


def _at(ranks, mesh, i, j):
    return ranks[i * mesh[1] + j]


def _check_grad_case(inp, ref, ranks, mesh, name):
    dp, tp = mesh
    key = mesh_id(mesh)
    v_l, t_l = V // tp, T // dp
    for j in range(tp):
        gw = sum(_at(ranks, mesh, i, j)[name][1] for i in range(dp))
        close(gw, ref[f"{key}_{name}_gw"][j * v_l:(j + 1) * v_l],
              what=f"{name} dL/dw shard {j}")
        for i in range(dp):
            loss, _, gh = _at(ranks, mesh, i, j)[name]
            toks = slice(i * t_l, (i + 1) * t_l)
            close(loss, ref[f"{key}_{name}_loss"][toks],
                  what=f"{name} loss ({i}, {j})")
            close(gh, ref[f"{key}_{name}_gh"][toks],
                  what=f"{name} dL/dh ({i}, {j})")


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
@pytest.mark.parametrize("name", ["full", "full_bias_abs", "pos"])
def test_deterministic_losses_and_gradients(runs, mesh, name):
    inp, ref, ranks = runs
    _check_grad_case(inp, ref, ranks[mesh], mesh, name)


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_full_softmax_equals_unsharded(runs, mesh):
    """The sharded full softmax and its gradients against the port's
    unsharded loss on the whole table."""
    from repro_torch.core.sampled_softmax import full_softmax_loss

    inp, _, ranks = runs
    dp, tp = mesh
    w = torch.from_numpy(inp["w"]).requires_grad_(True)
    h = torch.from_numpy(inp["h"]).requires_grad_(True)
    loss = full_softmax_loss(w, h, torch.from_numpy(inp["labels"]).long())
    loss.sum().backward()
    t_l, v_l = T // dp, V // tp
    for i in range(dp):
        for j in range(tp):
            got, _, gh = _at(ranks[mesh], mesh, i, j)["full"]
            toks = slice(i * t_l, (i + 1) * t_l)
            close(got, loss.detach().numpy()[toks], what="loss")
            close(gh, h.grad.numpy()[toks], what="dL/dh")
    for j in range(tp):
        gw = sum(_at(ranks[mesh], mesh, i, j)["full"][1] for i in range(dp))
        close(gw, w.grad.numpy()[j * v_l:(j + 1) * v_l], what="dL/dw")


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_argmax_and_topk(runs, mesh):
    """Ids exactly (a tie across shards goes to the lowest id), values in
    fp32, against the reference's sharded results and the dense ones."""
    inp, ref, ranks = runs
    dp, tp = mesh
    key, t_l = mesh_id(mesh), T // dp
    for r, res in enumerate(ranks[mesh]):
        toks = slice((r // tp) * t_l, (r // tp + 1) * t_l)
        for tag, table in (("argmax", "w"), ("argmax_tie", "w_tie")):
            ids, best = res[tag]
            np.testing.assert_array_equal(ids, ref[f"{key}_{tag}_ids"][toks])
            close(best, ref[f"{key}_{tag}_best"][toks])
            logits = inp["h"][toks] @ inp[table].T
            np.testing.assert_array_equal(ids, np.argmax(logits, axis=-1))
        ids, vals = res["topk"]
        np.testing.assert_array_equal(ids, ref[f"{key}_topk_ids"][toks])
        close(vals, ref[f"{key}_topk_vals"][toks])
        logits = inp["h"][toks] @ inp["w_tie"].T + inp["bias"]
        order = np.argsort(-logits, axis=-1, kind="stable")[:, :K]
        np.testing.assert_array_equal(ids, order)
    assert (ranks[mesh][0]["argmax_tie"][0] != V - 3).all()


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_partition_diagnostics(runs, mesh):
    inp, ref, ranks = runs
    dp, tp = mesh
    t_l = T // dp
    want = ref[f"{mesh_id(mesh)}_diag"]  # (T, tp): shard j's share
    for r, res in enumerate(ranks[mesh]):
        i, j = divmod(r, tp)
        close(res["diag"], want[i * t_l:(i + 1) * t_l, j])
    total = sum(ranks[mesh][j]["diag"] for j in range(tp))
    close(total, np.ones_like(total))


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
@pytest.mark.parametrize("case", [c[0] for c in SAMPLED])
def test_sampled_estimators_at_given_negatives(runs, mesh, case):
    """Loss, every head shard's gradient and dL/dh of each estimator on
    the same per-shard negatives as the reference (accidental hits
    included; the fused route, the einsum route, shared negatives)."""
    inp, ref, ranks = runs
    _check_grad_case(inp, ref, ranks[mesh], mesh, case)


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
@pytest.mark.parametrize("case", TAPAS)
def test_tapas_pool_gradient_reaches_owning_shard(runs, mesh, case):
    """The tapas pool's all-gather: the loss and gradients equal the
    reference's, and a pool row drawn by shard j gets its gradient on
    shard j alone."""
    inp, ref, ranks = runs
    _check_grad_case(inp, ref, ranks[mesh], mesh, case)
    dp, tp = mesh
    pool = inp[f"{mesh_id(mesh)}_pool"]
    p_l = POOL // tp
    labels = inp["labels"]
    v_l = V // tp
    for j in range(tp):
        gw = sum(_at(ranks[mesh], mesh, i, j)[case][1] for i in range(dp))
        own = set(pool[:, j * p_l:(j + 1) * p_l].ravel().tolist())
        own |= {int(lbl) - j * v_l for lbl in labels if lbl // v_l == j}
        touched = set(np.nonzero(np.abs(gw).sum(-1))[0].tolist())
        assert touched and touched <= own, (j, touched, own)


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_draws_follow_the_local_q(runs, mesh):
    """Each shard's draws against its local q (chi-square p > 1e-3 or TV
    < 0.02) and their logq equal to the local logq - log tp; padding rows
    never drawn."""
    from test_sampler_stats import _check_counts

    _, _, ranks = runs
    for r, res in enumerate(ranks[mesh]):
        d = res["draws"]
        assert d["logq_err"] < 1e-5
        assert d["counts"][d["n_valid"]:].sum() == 0
        _check_counts(d["counts"], d["q"], f"rank {r} of {mesh}", DRAWS)


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_geometry_and_collectives(runs, mesh):
    """Shard count, index, offset and local labels; the fused route's
    collectives: forward one pmax and two psums of (T,) fp32, backward the
    replicated h's one (T, d) psum."""
    inp, _, ranks = runs
    dp, tp = mesh
    t_l, v_l = T // dp, V // tp
    for r, res in enumerate(ranks[mesh]):
        i, j = divmod(r, tp)
        size, idx, off, local = res["geometry"]
        assert (size, idx, off) == (tp, j, j * v_l)
        np.testing.assert_array_equal(
            local, inp["labels"][i * t_l:(i + 1) * t_l] - j * v_l)
        c = res["collectives"]
        assert c["forward"] == {"all_reduce_sum": {"calls": 2,
                                                   "bytes": 2 * 4 * t_l},
                                "all_reduce_max": {"calls": 1,
                                                   "bytes": 4 * t_l}}
        assert c["backward"] == {"all_reduce_sum": {"calls": 1,
                                                    "bytes": 4 * t_l * D}}


def test_single_shard_needs_no_group():
    """group=None is one shard: no collective, the unsharded numbers."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.sampled_softmax import full_softmax_loss

    inp = _inputs()
    w, h = torch.from_numpy(inp["w"]), torch.from_numpy(inp["h"])
    labels = torch.from_numpy(inp["labels"]).long()
    dist.reset_collective_counts()
    close(dist.sharded_full_softmax_loss(w, h, labels, group=None),
          full_softmax_loss(w, h, labels))
    ids, _ = dist.sharded_logits_topk(w, h, K, group=None)
    np.testing.assert_array_equal(
        ids.numpy(), np.argsort(-(inp["h"] @ inp["w"].T), axis=-1,
                                kind="stable")[:, :K])
    assert dist.collective_counts() == {}
    assert (dist.axis_size(None), dist.axis_index(None)) == (1, 0)


def _one_rank_worker(ctx, inp: dict) -> dict:
    """The sharded full softmax over this world's one-rank model group and
    the one-device loss, each with its gradients and the collectives the
    sharded one made."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.sampled_softmax import full_softmax_loss

    labels = torch.from_numpy(inp["labels"]).long()
    bias = torch.from_numpy(inp["bias"])
    out = {}
    for name, abs_mode, b in (("full", False, None),
                              ("full_bias_abs", True, bias)):
        pair = []
        for sharded in (True, False):
            w = torch.from_numpy(inp["w"]).requires_grad_(True)
            h = torch.from_numpy(inp["h"]).requires_grad_(True)
            dist.reset_collective_counts()
            if sharded:
                loss = dist.sharded_full_softmax_loss(
                    w, h, labels, group=ctx.model_group, abs_mode=abs_mode,
                    bias_local=b)
            else:
                loss = full_softmax_loss(w, h, labels, abs_mode=abs_mode,
                                         bias=b)
            loss.sum().backward()
            pair.append((loss.detach(), w.grad, h.grad,
                         dist.collective_counts()))
        out[name] = pair
    return out


def test_one_rank_group_runs_the_collectives_bitwise(tmp_path):
    """A model group of one rank (a (1, 1) mesh) still runs the sharded
    formula, its pmax and both psums, and equals the one-device loss and
    its gradients bitwise."""
    res = Ranks(_one_rank_worker, (1, 1), tmp_path, _inputs()).result()[0]
    for name, (sharded, plain) in res.items():
        for got, want, what in zip(sharded[:3], plain[:3],
                                   ("loss", "dL/dw", "dL/dh")):
            assert torch.equal(got, want), f"{name} {what}"
        assert {op: c["calls"] for op, c in sharded[3].items()} == {
            "all_reduce_sum": 2, "all_reduce_max": 1}, name
        assert plain[3] == {}, name
