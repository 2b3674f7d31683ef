"""The port's facade (``repro_torch.api.SoftmaxHead``) and the Fig. 1b sparse
refresh, against the JAX package on the CPU.

  * the surface: every entry of ``tests/golden/api_surface.json`` exists in
    the port with the reference's parameter names, kinds, order and
    defaults (the port may add a trailing keyword-only ``device``);
  * the README quickstart's ``tree-quadratic`` part on the port, with its
    ``recall > 0.8``;
  * ``init`` / ``refresh`` statistics (rtol 1e-5: fp32 Gram sums in other
    orders), ``all_class_logq`` and the reported logq of the port's draws
    (1e-5), the sampled-softmax and nce losses and their gradients at the
    port's draws (1e-5), ``full``, ``export_index`` / ``decode_topk``, each
    against ``repro.api.SoftmaxHead`` on the same numpy inputs;
  * ``update_rows`` / ``update_path`` / ``update_feature_rows`` of the
    block, tree and rff samplers against the reference's functions (1e-5)
    and against a full rebuild after the same write (rtol = atol = 1e-4,
    the reference's ``tests/test_blocks.py`` tolerance; ``wq`` and the
    counts bitwise).
"""
import dataclasses
import inspect
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi_facade
from repro.configs import get_config as jget_config
from repro.core import blocks as jblocks
from repro.core import estimators as jest
from repro.core import samplers as jsamplers
from repro.core import tree as jtree
from repro.serve import retrieval as jretrieval
import repro_torch.api as api_facade
from repro_torch.api import SoftmaxHead
from repro_torch.configs import get_config
from repro_torch.core import blocks, estimators, samplers, tree
from repro_torch.core.samplers import SamplerState
from repro_torch.serve import retrieval

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "api_surface.json"
SURFACE = sorted(json.loads(GOLDEN.read_text()))


def _resolve(mod, name):
    obj = mod
    for part in name.split("."):
        obj = inspect.getattr_static(obj, part) if inspect.isclass(obj) \
            else getattr(obj, part)
    return obj


def _params(obj):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(obj).parameters.values()]


@pytest.mark.parametrize("name", SURFACE)
def test_surface_matches_the_reference(name):
    ref, mine = _resolve(japi_facade, name), _resolve(api_facade, name)
    if isinstance(ref, property):
        assert isinstance(mine, property), name
        return
    assert inspect.isclass(ref) == inspect.isclass(mine), name
    want, got = _params(ref), _params(mine)
    extra = got[len(want):]
    assert got[:len(want)] == want, name
    assert all(p[0] == "device" and p[1] == inspect.Parameter.KEYWORD_ONLY
               for p in extra), (name, extra)
    if "." not in name:
        assert name in api_facade.__all__


def test_all_lists_the_references_names():
    assert sorted(api_facade.__all__) == sorted(japi_facade.__all__)


# -- the README quickstart's tree-quadratic part ------------------------------

def _quick_cfg(jax_side=False, **kw):
    get = jget_config if jax_side else get_config
    cfg = get("youtube-dnn").reduced(vocab_size=512, sampler_block=16,
                                     tower_dims=(64, 32))
    return dataclasses.replace(
        cfg, **{"sampler": "tree-quadratic", "m_negatives": 32, **kw})


def _inputs(n=512, d=32, t=64, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(n, d)) * 0.3).astype(np.float32)
    h = rng.normal(size=(t, d)).astype(np.float32)
    labels = rng.integers(0, n, (t,)).astype(np.int32)
    return w, h, labels


def test_readme_quickstart_tree_part():
    cfg = _quick_cfg()
    head = SoftmaxHead(cfg)
    w_np, h_np, labels_np = _inputs()
    w, h = torch.from_numpy(w_np), torch.from_numpy(h_np)
    labels = torch.from_numpy(labels_np.astype(np.int64))
    state = head.init(torch.Generator().manual_seed(3), w)
    losses = head.loss(w, h, labels, state=state,
                       key=torch.Generator().manual_seed(4))
    assert losses.shape == (64,) and torch.isfinite(losses).all()
    full = SoftmaxHead(dataclasses.replace(cfg, estimator="full"))
    full_loss = full.loss(w, h, labels)
    jfull = japi_facade.SoftmaxHead(_quick_cfg(True, estimator="full"))
    np.testing.assert_allclose(
        full_loss.numpy(), np.asarray(jfull.loss(w_np, h_np, labels_np)),
        rtol=1e-5)
    nce = SoftmaxHead(dataclasses.replace(cfg, estimator="nce"))
    assert torch.isfinite(nce.loss(w, h, labels, state=state,
                                   key=torch.Generator().manual_seed(4))
                          ).all()
    index = head.export_index(w, leaf_size=4)
    beam = index.num_leaves_shard // 4
    ids, logits = head.decode_topk(w, h, 10, index=index, beam=beam)
    assert ids.shape == logits.shape == (64, 10)
    recall = retrieval.recall_at_k(index, w, h, 10, beam)
    assert recall > 0.8


def test_facade_refusals():
    head = SoftmaxHead(_quick_cfg())
    w = torch.zeros((100, 32))
    with pytest.raises(ValueError, match="class table has 100 rows"):
        head.init(torch.Generator(), w)
    with pytest.raises(NotImplementedError, match="A17"):
        head.export_index(torch.zeros((512, 32)),
                          ctx=dataclasses.make_dataclass("C", ["mesh"])(1))
    tapas = SoftmaxHead(_quick_cfg(sampler="tapas"))
    state = tapas.init(torch.Generator(), torch.zeros((512, 32)))
    with pytest.raises(ValueError, match="pass w="):
        tapas.sample(state, torch.zeros((2, 32)), torch.Generator())
    with pytest.raises(TypeError, match="carries no state"):
        SoftmaxHead(_quick_cfg(sampler="softmax")).sample(
            state, torch.zeros((2, 32)), torch.Generator())
    shared = SoftmaxHead(_quick_cfg(sampler="block-quadratic-shared"))
    w = torch.randn((512, 32), generator=torch.Generator().manual_seed(1))
    ids, logq = shared.sample(shared.init(torch.Generator(), w),
                              torch.randn((2, 32)), torch.Generator(), m=5)
    assert ids.shape == logq.shape == (5,)
    with pytest.raises(ValueError, match="explicit `key`"):
        head.loss(torch.zeros((512, 32)), torch.zeros((2, 32)),
                  torch.zeros((2,), dtype=torch.int64), state=None)
    with pytest.raises(ValueError, match="without an index"):
        head.decode_topk(w, torch.zeros((2, 32)), 3, beam=4)


# -- init / refresh / sample / loss against the reference ---------------------

FAMILIES = ["block-quadratic", "tree-quadratic", "rff", "midx"]


def _jall_class_logq(jsmp, runtime, h):
    if isinstance(jsmp, jsamplers.TreeSampler):
        return jtree.all_class_logq(runtime["stats"], jsmp.kernel, h,
                                    runtime["proj"])
    if isinstance(jsmp, jsamplers.BlockSampler):
        return jblocks.all_class_logq(runtime["stats"], jsmp.kernel, h,
                                      runtime["proj"])
    return jsmp.all_class_logq(runtime, h)


def _all_class_logq(smp, runtime, h):
    if isinstance(smp, samplers.TreeSampler):
        return tree.all_class_logq(runtime["stats"], smp.kernel, h,
                                   runtime["proj"])
    if isinstance(smp, samplers.BlockSampler):
        return blocks.all_class_logq(runtime["stats"], smp.kernel, h,
                                     runtime["proj"])
    return smp.all_class_logq(runtime, h)


def _close(got: dict, want: dict, rtol=1e-5, atol=1e-5):
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        if v.dtype.kind == "i":
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), v, rtol=rtol,
                                       atol=atol, err_msg=k)


def _pair(family):
    kw = dict(sampler=family, m_negatives=16)
    cfg, jcfg = _quick_cfg(**kw), _quick_cfg(True, **kw)
    return SoftmaxHead(cfg), japi_facade.SoftmaxHead(jcfg)


@pytest.mark.parametrize("family", FAMILIES)
def test_facade_matches_the_reference(family):
    """From one table: the reference's constants carried over, the port's
    init/refresh give its statistics, the port's draws report the
    reference's exact logq at their ids, and the sampled-softmax and nce
    losses at those draws (with their gradients) and the full loss agree."""
    head, jhead = _pair(family)
    cfg = head.cfg
    w_np, h_np, labels_np = _inputs(t=8)
    w, h = torch.from_numpy(w_np), torch.from_numpy(h_np)
    labels = torch.from_numpy(labels_np.astype(np.int64))
    jstate = jax.jit(jhead.init)(jax.random.PRNGKey(3), w_np)
    jstate = jax.jit(jhead.refresh)(jstate, w_np)
    state = head.init(torch.Generator().manual_seed(3), w)
    assert set(state.stats) == set(jstate.stats)
    assert set(state.const) == set(jstate.const)
    state = head.refresh(SamplerState(
        stats=state.stats,
        const={k: torch.from_numpy(np.array(v))
               for k, v in jstate.const.items()}), w)
    _close(state.stats, jstate.stats)
    if not state.const:  # no random constant: init alone gives the stats
        _close(head.init(torch.Generator(), w).stats, jstate.stats)

    ids, logq = head.sample(state, h, torch.Generator().manual_seed(5))
    assert ids.shape == logq.shape == (8, cfg.m_negatives)
    assert int(ids.max()) < cfg.vocab_size
    smp, jsmp = head.sampler, jhead.sampler
    runtime = smp.hydrate(state, cfg.vocab_size)
    jruntime = jsmp.hydrate(jstate, jnp.asarray(cfg.vocab_size, jnp.int32))
    joracle = jax.jit(lambda r, q: _jall_class_logq(jsmp, r, q))
    for t in range(h.shape[0]):
        mine = _all_class_logq(smp, runtime, h[t])
        want = np.asarray(joracle(jruntime, h_np[t]))
        np.testing.assert_allclose(mine.numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(logq[t].numpy(), want[ids[t].numpy()],
                                   rtol=1e-5, atol=1e-5)

    neg = ids.numpy().astype(np.int32)
    for est in ("sampled-softmax", "nce"):
        c = dataclasses.replace(cfg, estimator=est)
        h_ = dataclasses.replace(head, cfg=c)
        wt = w.clone().requires_grad_()
        loss = h_.loss(wt, h, labels, state=state,
                       key=torch.Generator().manual_seed(5))
        # the facade draws exactly what sample() drew from the same seed
        at_draws = estimators.loss_from_embeddings(
            h_.estimator, w, h, labels, ids, logq,
            abs_mode=c.abs_softmax, impl=c.head_impl)
        assert torch.equal(loss.detach(), at_draws), est
        loss.sum().backward()

        def jloss(w_, e=est):
            return jnp.sum(jest.loss_from_embeddings(
                jest.make_estimator(e), w_, h_np, labels_np, neg,
                logq.numpy(), abs_mode=c.abs_softmax))
        jl, jg = jax.jit(jax.value_and_grad(jloss))(w_np)
        np.testing.assert_allclose(float(loss.sum().detach()), float(jl),
                                   rtol=1e-5)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-6, err_msg=est)

    full = dataclasses.replace(head, cfg=dataclasses.replace(
        cfg, estimator="full"))
    jfull = japi_facade.SoftmaxHead(dataclasses.replace(
        jhead.cfg, estimator="full"))
    np.testing.assert_allclose(
        full.loss(w, h, labels).detach().numpy(),
        np.asarray(jfull.loss(w_np, h_np, labels_np)), rtol=1e-5)


@pytest.mark.parametrize("leaf", [16, 32])
def test_export_index_and_decode_topk_match_the_reference(leaf):
    head, jhead = _pair("tree-quadratic")
    w_np, h_np, _ = _inputs(t=16, seed=2)
    w, h = torch.from_numpy(w_np), torch.from_numpy(h_np)
    index = head.export_index(w, leaf_size=leaf)
    jindex = jax.jit(lambda w_: jhead.export_index(w_, leaf_size=leaf))(
        w_np)
    ids, logits = head.decode_topk(w, h, 10, index=index)
    jids, jlogits = jax.jit(lambda i, h_: jhead.decode_topk(
        w_np, h_, 10, index=i))(jindex, h_np)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    dids, dlogits = head.decode_topk(w, h, 10)
    assert torch.equal(ids, dids)  # full beam = the dense top-k
    jd = jretrieval.dense_topk(w_np, h_np, 10, n_valid=head.cfg.vocab_size)
    np.testing.assert_array_equal(dids.numpy(), np.asarray(jd[0]))
    np.testing.assert_allclose(dlogits.numpy(), np.asarray(jd[1]),
                               rtol=1e-5, atol=1e-5)


# -- the Fig. 1b sparse refresh -----------------------------------------------

SPARSE = ["block-quadratic", "tree-quadratic", "rff"]


def _stats_tensors(stats) -> dict:
    """Every tensor of a runtime stats object, by field (and level)."""
    out = {}
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        if isinstance(v, tuple):
            out.update({f"{f.name}[{i}]": x for i, x in enumerate(v)})
        elif isinstance(v, torch.Tensor) or hasattr(v, "shape"):
            out[f.name] = v
    return out


@pytest.mark.parametrize("family", SPARSE)
def test_sparse_refresh_matches_reference_and_rebuild(family):
    head, jhead = _pair(family)
    cfg = head.cfg
    w_np, _, _ = _inputs(seed=4)
    rng = np.random.default_rng(5)
    ids_np = rng.choice(cfg.vocab_size, 24, replace=False).astype(np.int32)
    w_new_np = (rng.normal(size=(24, w_np.shape[1])) * 0.3
                ).astype(np.float32)
    w = torch.from_numpy(w_np)
    ids, w_new = torch.from_numpy(ids_np), torch.from_numpy(w_new_np)

    jstate = jax.jit(jhead.init)(jax.random.PRNGKey(3), w_np)
    state = head.refresh(SamplerState(
        stats={}, const={k: torch.from_numpy(np.array(v))
                         for k, v in jstate.const.items()}), w)
    smp, jsmp = head.sampler, jhead.sampler
    n = jnp.asarray(cfg.vocab_size, jnp.int32)
    upd = smp.update_rows(smp.hydrate(state, cfg.vocab_size), ids, w_new)
    jupd = jax.jit(jsmp.update_rows)(jsmp.hydrate(jstate, n), ids_np,
                                     w_new_np)
    got, want = _stats_tensors(upd["stats"]), _stats_tensors(jupd["stats"])
    assert set(got) == set(want) - {"n_valid"} | {"n_valid"}
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-5, err_msg=k)

    w2 = w.clone()
    w2[ids.long()] = w_new
    full = smp.hydrate(head.refresh(state, w2), cfg.vocab_size)["stats"]
    rebuilt = _stats_tensors(full)
    scale = 1.0
    if family == "rff":  # the rebuild re-derives the log shift
        scale = float(torch.exp(full.logshift - upd["stats"].logshift))
    for k, v in got.items():
        if k == "logshift":
            continue
        if k == "wq" or k.startswith("levels_cnt") or k == "n_valid":
            assert torch.equal(v, rebuilt[k]), k
        else:
            factor = scale if k.startswith("levels_f") else 1.0
            np.testing.assert_allclose((v / factor).numpy(),
                                       rebuilt[k].numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)


def test_blocks_update_rows_matches_the_references_function():
    rng = np.random.default_rng(6)
    w_np = rng.normal(size=(200, 8)).astype(np.float32)
    ids_np = np.array([3, 77, 150, 199], np.int32)
    w_new_np = rng.normal(size=(4, 8)).astype(np.float32)
    proj_np = (rng.normal(size=(5, 8)) / np.sqrt(5)).astype(np.float32)
    for proj in (None, proj_np):
        pt = None if proj is None else torch.from_numpy(proj)
        upd = blocks.update_rows(blocks.build(torch.from_numpy(w_np), 32, pt),
                                 torch.from_numpy(ids_np),
                                 torch.from_numpy(w_new_np), pt)
        jupd = jblocks.update_rows(jblocks.build(w_np, 32, proj), ids_np,
                                   w_new_np, proj)
        for k in ("z", "cnt", "wq"):
            np.testing.assert_allclose(getattr(upd, k).numpy(),
                                       np.asarray(getattr(jupd, k)),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
