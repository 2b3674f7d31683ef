"""The tree-quadratic, rff and midx samplers on a (data, model) mesh
(``core/samplers.py``, ``core/tree.py``, ``core/hierarchy.py``,
``core/midx.py``, ``train/step.py``, ``train/loop.py::RefreshIsland``)
against the reference's sharded refresh.

The ranks run on gloo (``torch_mesh_util``) at (1, 2), (2, 2) and (1, 4)
on ``youtube-dnn.reduced(vocab_size=247, sampler_block=16)``: the last
shard is padded at tp 2 and 4 (124 + 123, 62 x 3 + 61 rows), and no
shard fills its last leaf or list.  The reference runs its
``make_refresh_fn(cfg, ctx)`` under its ``shard_map`` in one subprocess
of 8 host devices, the head sharded ("model", "data") as the rules lay it
out, and gathers its feature dim over ``data`` inside the island.

  * each rank's statistics (``make_refresh_fn`` on the rank's head shard,
    its feature dim gathered over ``data``) against the reference's shard
    of its tp-stacked statistics: floats within the unsharded builds'
    tolerance (rtol 1e-5, atol 1e-6), counts, ``perm``, ``codes`` and the
    leaf tables exactly; their shapes ``shard_state_shapes``;
  * each rank's stratified draws against its local ``all_class_logq`` by
    ``tests/test_sampler_stats.py``'s gates, the returned logq equal to
    the local logq - log tp, no id at or past the shard's ``n_valid``;
  * a 3-step ``fit`` per family and mesh: losses finite and alike on
    every rank, the carried state at ``shard_state_shapes``, rff's
    ``omega`` alike on every rank;
  * the overlap island at (2, 2), where the head's feature dim is sharded
    over ``data``: every rank swaps at the same steps, and each swapped-in
    state is exactly ``build_stats`` of the rank's rows of the whole head
    (gathered apart, by ``step.gather_params``) at the dispatch step;
  * tapas over a tree-quadratic base through one ``fit`` step;
  * ``sharded_partition_diagnostics`` on tree statistics against the
    reference's under ``shard_map``.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from torch_mesh_util import MESHES, Reference, close, mesh_id, start_meshes

torch.set_num_threads(1)

VOCAB, LEAF, SEED = 247, 16, 5
FAMILIES = ("tree-quadratic", "rff", "midx")
FIT_STEPS = 3
DRAWS = 24_000
#: the overlap run: cadence 2, swapped in one step after dispatch
OVERLAP_MESH = (2, 2)
OVERLAP_STEPS = 6
TAPAS_MESH = (1, 2)
DIAG_QUERIES = 8


def _cfg(family: str, **changes):
    from repro_torch.configs import get_config

    return get_config("youtube-dnn").reduced(
        vocab_size=VOCAB, sampler=family, sampler_block=LEAF, **changes)


def _inputs() -> dict:
    cfg = _cfg("rff")
    d = cfg.tower_dims[-1]
    rng = np.random.default_rng(SEED)
    return {"head": (rng.normal(size=(VOCAB, d)) * 0.3).astype(np.float32),
            "omega": rng.normal(size=(cfg.rff_dim, d)).astype(np.float32),
            "h": rng.normal(size=(DIAG_QUERIES, d)).astype(np.float32),
            "meshes": np.asarray(MESHES, np.int32)}


REF_SCRIPT = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from repro.configs import get_config
from repro.core import distributed as D
from repro.core.samplers import SamplerState, sampler_from_config
from repro.sharding.rules import ShardCtx
from repro.train import step
from repro.utils.compat import shard_map

inp = dict(np.load(sys.argv[1]))
vocab, leaf = int(inp["vocab"]), int(inp["leaf"])
out = {}
for dp, tp in [tuple(x) for x in inp["meshes"]]:
    mesh = Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))
    ctx = ShardCtx(mesh=mesh)
    v_l = -(-vocab // tp)
    head = np.zeros((tp * v_l, inp["head"].shape[1]), np.float32)
    head[:vocab] = inp["head"]
    key = f"{dp}x{tp}"
    for fam in ("tree-quadratic", "rff", "midx"):
        cfg = get_config("youtube-dnn").reduced(
            vocab_size=vocab, sampler=fam, sampler_block=leaf)
        const = {"omega": jnp.asarray(inp["omega"])} if fam == "rff" else {}
        st = jax.jit(step.make_refresh_fn(cfg, ctx))(
            jnp.asarray(head), SamplerState(stats={}, const=const))
        for k, v in st.stats.items():
            out[f"{key}_{fam}_{k}"] = np.asarray(v)
        if fam != "tree-quadratic":
            continue
        smp = sampler_from_config(cfg)

        def diag(stats, h):
            my = lax.axis_index("model")
            n_valid = jnp.clip(vocab - my * v_l, 0, v_l)
            rt = smp.hydrate(SamplerState(stats=stats, const={}), n_valid)
            return D.sharded_partition_diagnostics(
                rt, smp, h, axis_name="model")[:, None]

        specs = {k: P("model") for k in st.stats}
        out[f"{key}_diag"] = np.asarray(jax.jit(shard_map(
            diag, mesh=mesh, check_vma=False, in_specs=(specs, P("data")),
            out_specs=P("data", "model")))(st.stats, jnp.asarray(inp["h"])))
np.savez(sys.argv[2], **out)
'''


def _numpy(named: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in named.items()}


def _shapes(named: dict) -> dict:
    return {k: tuple(v.shape) for k, v in named.items()}


def _rank_rows(ctx, head: np.ndarray) -> torch.Tensor:
    """The rank's head rows as the train step reads them: its
    ("model", "data") shard of the padded head, the feature dim gathered
    over ``data``."""
    from repro_torch.sharding import rules

    local = rules.shard_by_spec(rules.pad_rows(torch.from_numpy(head),
                                               ctx.tp),
                                (ctx.model_axis, "data"), ctx)
    return rules.gather_head_fd(ctx, local)


def _refresh(ctx, inp: dict, family: str):
    from repro_torch.core.samplers import SamplerState
    from repro_torch.train import step

    cfg = _cfg(family)
    const = ({"omega": torch.from_numpy(inp["omega"])} if family == "rff"
             else {})
    return step.make_refresh_fn(cfg, ctx)(_rank_rows(ctx, inp["head"]),
                                          SamplerState({}, const))


def _draws(ctx, state, family: str) -> dict:
    """This shard's stratified draws for one query, with its exact local
    q and the shard's n_valid."""
    from repro_torch.core import distributed
    from repro_torch.core.samplers import sampler_from_config
    from repro_torch.train import step

    cfg = _cfg(family)
    smp = sampler_from_config(cfg)
    n_valid = step.shard_n_valid(cfg, ctx)
    rt = smp.hydrate(state, n_valid)
    rng = np.random.default_rng(SEED + 1)
    h = torch.from_numpy(rng.normal(size=(1, cfg.tower_dims[-1])).astype(
        np.float32))
    gen = torch.Generator().manual_seed(7 + ctx.data_index)
    ids, logq = distributed.sharded_negative_sample(
        smp, rt, h, ctx.tp * DRAWS, gen, ctx.model_group)
    lq_all = smp.all_class_logq(rt, h[0])
    return {"counts": torch.bincount(ids[0],
                                     minlength=lq_all.shape[0]).numpy(),
            "q": torch.exp(lq_all).numpy(), "n_valid": n_valid,
            "max_id": int(ids.max()),
            "logq_err": float((logq[0] - (lq_all[ids[0]] - math.log(ctx.tp)))
                              .abs().max())}


def _fit(ctx, family: str, steps: int = FIT_STEPS, **changes) -> dict:
    from repro_torch.data.pipeline import batch_iterator_for
    from repro_torch.optim import make_optimizer
    from repro_torch.train import loop

    cfg = _cfg(family, **changes)
    res = loop.fit(cfg, ctx, make_optimizer("adamw", 1e-2),
                   batch_iterator_for(cfg, ctx, 16, 1, device="cpu"),
                   steps, log_every=0, device="cpu")
    st = res.state.sampler_state
    return {"losses": res.losses, "stats": _shapes(st.stats),
            "const": _numpy(st.const), "swaps": res.refresh_swaps,
            "staleness": res.refresh_staleness}


def _overlap(ctx) -> dict:
    """Drive the island by hand over OVERLAP_STEPS steps at cadence 2,
    k 1: at each cadence step the rank's rows of the whole head
    (``gather_params``: gathered apart from the island's snapshot), and
    at each swap whether the swapped-in statistics equal ``build_stats``
    of the dispatch step's rows exactly."""
    from repro_torch.core.samplers import sampler_from_config
    from repro_torch.data.pipeline import batch_iterator_for
    from repro_torch.optim import make_optimizer
    from repro_torch.train import loop, step

    cfg = _cfg("midx", refresh_mode="overlap", sampler_refresh_every=2,
               refresh_stale_steps=1)
    smp = sampler_from_config(cfg)
    opt = make_optimizer("adamw", 1e-2)
    state = step.init_train_state(torch.Generator().manual_seed(0), cfg,
                                  ctx, opt, device="cpu")
    island = loop.RefreshIsland(cfg, ctx, "cpu")
    state = island.prime(state)
    step_fn = step.make_train_step(cfg, ctx, opt)
    data = batch_iterator_for(cfg, ctx, 16, 1, device="cpu")
    v_l, j = -(-cfg.vocab_size // ctx.tp), ctx.model_index
    n_valid = step.shard_n_valid(cfg, ctx)
    rows, swaps, exact = {}, [], []
    for i in range(OVERLAP_STEPS):
        if i % island.cadence == 0:
            whole = step.gather_params(state.params, ctx)["head_w"]
            rows[i] = whole[j * v_l:(j + 1) * v_l].clone()
        before = state.sampler_state
        state, _ = island.before_step(i, state)
        if state.sampler_state is not before:
            sent = i - island.k
            swaps.append(i)
            want = smp.build_stats(rows[sent], n_valid, {})
            got = state.sampler_state.stats
            exact.append(set(got) == set(want) and all(
                torch.equal(got[k], want[k]) for k in want))
        state, _ = step_fn(state, next(data),
                           loop.step_generator(0, i, torch.device("cpu")))
    return {"swaps": swaps, "exact": exact,
            "island_launches": dict(island.launches)}


def _diag(ctx, state, inp: dict):
    from repro_torch.core import distributed
    from repro_torch.core.samplers import sampler_from_config
    from repro_torch.sharding import rules
    from repro_torch.train import step

    cfg = _cfg("tree-quadratic")
    smp = sampler_from_config(cfg)
    rt = smp.hydrate(state, step.shard_n_valid(cfg, ctx))
    h = rules.batch_rows(torch.from_numpy(inp["h"]), ctx)
    return distributed.sharded_partition_diagnostics(
        rt, smp, h, group=ctx.model_group).numpy()


def _samplers_worker(ctx, inp: dict) -> dict:
    from repro_torch.core.samplers import sampler_from_config
    from repro_torch.train import step

    out: dict = {"stats": {}, "shard_shapes": {}, "n_valid": None,
                 "draws": {}, "fit": {}}
    out["n_valid"] = step.shard_n_valid(_cfg("midx"), ctx)
    for fam in FAMILIES:
        cfg = _cfg(fam)
        state = _refresh(ctx, inp, fam)
        out["stats"][fam] = _numpy(state.stats)
        out["shard_shapes"][fam] = _shapes(sampler_from_config(
            cfg).shard_state_shapes(cfg, ctx.tp).stats)
        out["draws"][fam] = _draws(ctx, state, fam)
        if fam == "tree-quadratic":
            out["diag"] = _diag(ctx, state, inp)
        out["fit"][fam] = _fit(ctx, fam)
    mesh = (ctx.dp, ctx.tp)
    if mesh == OVERLAP_MESH:
        out["overlap"] = _overlap(ctx)
        out["overlap_fit"] = _fit(
            ctx, "midx", OVERLAP_STEPS, refresh_mode="overlap",
            sampler_refresh_every=2, refresh_stale_steps=1)
    if mesh == TAPAS_MESH:
        out["tapas"] = _fit(ctx, "tapas", 1, tapas_base="tree-quadratic")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's stacked statistics and diagnostics, and each
    mesh's ranks' results, from the same inputs."""
    base = tmp_path_factory.mktemp("mesh_samplers")
    inp = _inputs()
    ref = Reference(REF_SCRIPT, {**inp, "vocab": VOCAB, "leaf": LEAF}, base)
    started = start_meshes(_samplers_worker, base, inp)
    ranks = {mesh: r.result() for mesh, r in started.items()}
    return inp, ref.result(), ranks


EXACT = {"cnt", "perm", "codes", "wq"}


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
@pytest.mark.parametrize("family", FAMILIES)
def test_shard_stats_match_reference(runs, mesh, family):
    """Each rank's statistics are the reference's shard of its
    tp-stacked statistics: floats within the unsharded builds'
    tolerance, counts, perm, codes and leaf tables exactly, each at
    ``shard_state_shapes``; the padding rows carry no mass."""
    _, ref, ranks = runs
    dp, tp = mesh
    key = mesh_id(mesh)
    for r, res in enumerate(ranks[mesh]):
        j = r % tp
        got = res["stats"][family]
        assert _shapes(got) == res["shard_shapes"][family], r
        for k, v in got.items():
            whole = ref[f"{key}_{family}_{k}"]
            n = whole.shape[0] // tp
            want = whole[j * n:(j + 1) * n]
            if k in EXACT:
                np.testing.assert_array_equal(v, want,
                                              err_msg=f"{k} shard {j}")
            else:
                np.testing.assert_allclose(v, want, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{k} shard {j}")
        n_valid = res["n_valid"]
        cnt_key = {"rff": "aux"}.get(family, "cnt")
        leaf_cnt = got[cnt_key]
        if family != "midx":  # the heap's root holds the shard's count
            leaf_cnt = leaf_cnt[:1]
        assert float(leaf_cnt.sum()) == n_valid, (r, family)
        wq = got["wq"].reshape(-1, got["wq"].shape[-1])
        pad = (np.arange(wq.shape[0]) >= n_valid) if family != "midx" else \
            (got["perm"] >= n_valid)
        assert pad.any() and not wq[pad].any(), (r, family)


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
@pytest.mark.parametrize("family", FAMILIES)
def test_draws_follow_the_shards_local_q(runs, mesh, family):
    """Each shard's draws against its local q (chi-square p > 1e-3 or TV
    < 0.02); their logq the local logq - log tp; no id at or past the
    shard's n_valid."""
    from test_sampler_stats import _check_counts

    for r, res in enumerate(runs[2][mesh]):
        d = res["draws"][family]
        assert d["logq_err"] < 1e-4, (r, d["logq_err"])
        assert d["max_id"] < d["n_valid"]
        assert d["counts"][d["n_valid"]:].sum() == 0
        _check_counts(d["counts"], d["q"], f"{family} rank {r} of {mesh}",
                      DRAWS)


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
@pytest.mark.parametrize("family", FAMILIES)
def test_fit_keeps_the_shard_state(runs, mesh, family):
    """Three fit steps: losses finite and alike on every rank, the
    carried statistics at ``shard_state_shapes``, the constants (rff's
    omega) alike on every rank."""
    ranks = runs[2][mesh]
    first = ranks[0]["fit"][family]
    assert len(first["losses"]) == FIT_STEPS
    assert np.isfinite(first["losses"]).all()
    for r, res in enumerate(ranks):
        got = res["fit"][family]
        assert got["losses"] == first["losses"], r
        assert got["stats"] == res["shard_shapes"][family], r
        assert set(got["const"]) == set(first["const"])
        for k, v in got["const"].items():
            np.testing.assert_array_equal(v, first["const"][k], err_msg=k)
    if family == "rff":
        assert set(first["const"]) == {"omega"}


def test_overlap_island_swaps_the_gathered_rebuild(runs):
    """At (2, 2) every rank swaps at the same steps (cadence 2, k 1: 1, 3,
    5), each swapped-in state exactly ``build_stats`` of the rank's rows
    of the whole head at the dispatch step; the island's rebuilds counted
    apart (none here: the plain versions count nothing); an overlap
    ``fit`` swaps as often on every rank, with the same staleness (the
    steps since the head its statistics came from) and losses."""
    ranks = runs[2][OVERLAP_MESH]
    for r, res in enumerate(ranks):
        got = res["overlap"]
        assert got["swaps"] == [1, 3, 5], (r, got["swaps"])
        assert got["exact"] == [True] * 3, (r, got["exact"])
        assert not any(got["island_launches"].values())
        fit = res["overlap_fit"]
        assert fit["swaps"] == 3 and fit["staleness"] == [0, 1, 2, 1, 2, 1]
        assert fit["losses"] == ranks[0]["overlap_fit"]["losses"]
        assert np.isfinite(fit["losses"]).all()


def test_tapas_over_a_tree_base_fits(runs):
    ranks = runs[2][TAPAS_MESH]
    first = ranks[0]["tapas"]
    assert len(first["losses"]) == 1 and np.isfinite(first["losses"]).all()
    for res in ranks:
        assert res["tapas"]["losses"] == first["losses"]
        assert res["tapas"]["stats"] == res["shard_shapes"]["tree-quadratic"]


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_partition_diagnostics_on_tree_stats(runs, mesh):
    """Each rank's share of the kernel mass from its tree's root against
    the reference's under ``shard_map``; the shares sum to 1."""
    _, ref, ranks = runs
    dp, tp = mesh
    t_l = DIAG_QUERIES // dp
    want = ref[f"{mesh_id(mesh)}_diag"]
    for r, res in enumerate(ranks[mesh]):
        i, j = divmod(r, tp)
        close(res["diag"], want[i * t_l:(i + 1) * t_l, j])
    total = sum(ranks[mesh][j]["diag"] for j in range(tp))
    close(total, np.ones_like(total))
