"""The port's train step on a (data, model) mesh (``train/step.py``,
``train/loop.py``, ``data/pipeline.py``, ``sharding/rules.py``,
``launch/mesh.py``) against the reference's single-host results.

The ranks run on gloo (``torch_mesh_util``) at (1, 2), (2, 2) and (1, 4);
the reference runs here, on one host device, since what is held is
computed shard by shard or equals the unsharded step:

  * the sharded refresh's statistics of each shard against the
    reference's ``sampler.build_stats`` on that shard's rows and n_valid
    (vocab 250: the last shard padded), with and without a projection;
  * batch placement: each data rank's rows of the global batch;
  * one step with ``estimator="full"`` (clip + AdamW) against the
    reference's ``mesh=None`` step and the port's own, on
    ``youtube-dnn.reduced()`` and ``llama3-8b.reduced(vocab_size=500)``
    (its KV heads padded to 4 at tp 4, as ``init_lm`` pads them for the
    mesh): the loss and every updated parameter gathered from the rank's
    shards, fp32 within 1e-5;
  * the clip's global norm of a rank's ``ShardedGrads`` (its head shard,
    the rest whole) equal to the norm of the whole gradients, and the
    clipped shards equal to the whole clip's rows, at a norm above the
    clip threshold;
  * three ``fit`` steps of block-quadratic and tapas: finite losses alike
    on every rank, every parameter gathered alike on every rank;
  * what the head-only mesh refused and now runs (``pure_fsdp``, the
    backbone's specs, a tied head, Adafactor, the tree, rff and midx
    samplers, the overlap island), and the parts left for later, which
    raise ``NotImplementedError`` naming A17.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from torch_mesh_util import MESHES, close, mesh_id, start_meshes

torch.set_num_threads(1)

VOCAB_R, PROJ = 250, 8
FIT_STEPS = 3
FIT_FAMILIES = ("block-quadratic", "tapas")
REFRESH_FAMILIES = ("block-quadratic", "block-quadratic-shared")
STEP_CONFIGS = ("youtube-dnn", "llama3-8b")
BATCH = {"youtube-dnn": (16, 1), "llama3-8b": (4, 8)}
#: the meshes' model widths: an LM's tree is padded for each (init_lm)
TPS = sorted({tp for _, tp in MESHES})
#: AdamW's eps at 1e-3, as the port's dense step tests: at 1e-8 the first
#: step's update g / (|g| + eps) turns a 1e-13 difference of a ~1e-8
#: gradient into a visible one
STEP_OPT = dict(lr=1e-2, eps=1e-3)


def _cfg(name: str, **changes):
    from repro_torch.configs import get_config

    if name == "llama3-8b":
        changes.setdefault("vocab_size", 500)
    return get_config(name).reduced(**changes)


def _refresh_cfg(family: str):
    return _cfg("youtube-dnn", vocab_size=VOCAB_R, sampler=family,
                sampler_block=16, sampler_proj_rank=(
                    PROJ if family == "block-quadratic" else None))


def _numpy(named: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in named.items()}


def _unsharded_step(cfg, np_params, batch: dict) -> tuple:
    """The port's mesh=None step from the reference's parameters."""
    from repro_torch.optim import make_optimizer
    from repro_torch.train import step

    model = _module(cfg, np_params)
    opt = make_optimizer("adamw", **STEP_OPT)
    state = step.TrainState(model, opt.init(step.param_dict(model)),
                            step.empty_state(), 0)
    state, metrics = step.make_train_step(cfg, None, opt)(
        state, {k: torch.from_numpy(v.copy()) for k, v in batch.items()},
        torch.Generator().manual_seed(1))
    return float(metrics["loss"]), _numpy(dict(model.named_parameters()))


def _module(cfg, np_params):
    from repro_torch import convert
    from repro_torch.models.transformer import StackedLM

    p = convert.params_from_jax(np_params, cfg, device="cpu")
    return p if isinstance(p, torch.nn.Module) else StackedLM(
        cfg, "cpu", tree=p)


def _train_worker(ctx, inp: dict) -> dict:
    from repro_torch.core.samplers import SamplerState
    from repro_torch.data.pipeline import batch_iterator_for
    from repro_torch.optim import make_optimizer
    from repro_torch.sharding import rules
    from repro_torch.train import loop, step

    out: dict = {"refresh": {}, "steps": {}, "fit": {}}
    head = torch.from_numpy(inp["head"])
    for fam in REFRESH_FAMILIES:
        cfg = _refresh_cfg(fam)
        const = ({"proj": torch.from_numpy(inp["proj"])}
                 if cfg.sampler_proj_rank else {})
        new = step.make_refresh_fn(cfg, ctx)(rules.shard_rows(head, ctx),
                                             SamplerState({}, const))
        out["refresh"][fam] = _numpy(new.stats)

    cfg = _cfg("youtube-dnn")
    data = batch_iterator_for(cfg, ctx, 8, 1, seed=4, device="cpu")
    out["batches"] = [_numpy(next(data)) for _ in range(2)]

    for name in STEP_CONFIGS:
        cfg = _cfg(name, estimator="full")
        model = step.shard_params(
            _module(cfg, inp[f"{name}_params_tp{ctx.tp}"]), cfg, ctx)
        opt = make_optimizer("adamw", **STEP_OPT)
        state = step.TrainState(model, opt.init(step.param_dict(model)),
                                step.empty_state(), 0)
        batch = {k: rules.batch_rows(torch.from_numpy(v.copy()), ctx)
                 for k, v in inp[f"{name}_batch"].items()}
        state, metrics = step.make_train_step(cfg, ctx, opt)(
            state, batch, torch.Generator().manual_seed(1))
        out["steps"][name] = (float(metrics["loss"]),
                              _numpy(step.gather_params(model, ctx)))

    for fam in FIT_FAMILIES:
        cfg = _cfg("youtube-dnn", sampler=fam)
        res = loop.fit(cfg, ctx, make_optimizer("adamw", 1e-2),
                       batch_iterator_for(cfg, ctx, 16, 1, device="cpu"),
                       FIT_STEPS, log_every=0, device="cpu")
        out["fit"][fam] = (res.losses,
                           _numpy(step.gather_params(res.state.params, ctx)),
                           {k: tuple(v.shape) for k, v in
                            res.state.sampler_state.stats.items()},
                           tuple(res.state.params.head_w.shape))
    out["clip"] = _sharded_clip(ctx, _clip_grads())
    out["raises"] = _raises(ctx, inp["tmp"])
    out["ported"] = _ported(ctx)
    out["abstract"] = _abstract_vs_init(ctx)
    return out


def _clip_grads() -> dict:
    """Gradients of a whole model: a head table and two backbone tensors,
    their global norm well above the clip threshold of 1."""
    g = torch.Generator().manual_seed(9)
    return {"head_w": torch.randn((VOCAB_R, 8), generator=g),
            "tower": torch.randn((5, 8), generator=g),
            "bias": torch.randn((3,), generator=g)}


def _sharded_clip(ctx, whole: dict) -> tuple:
    """(global norm, clipped gradients) of this rank's ``ShardedGrads``:
    its head shard, the backbone whole."""
    from repro_torch.optim.clip import (
        ShardedGrads,
        clip_by_global_norm,
        global_norm,
    )
    from repro_torch.sharding import rules

    grads = ShardedGrads({k: rules.shard_rows(v, ctx) if k == "head_w"
                          else v.clone() for k, v in whole.items()},
                         {"head_w": (ctx.model_axis, None),
                          "tower": (None, None), "bias": (None,)}, ctx)
    norm = float(global_norm(grads))
    clipped, _ = clip_by_global_norm(1.0).update(grads, (), None)
    return norm, _numpy(clipped)


def _abstract_vs_init(ctx) -> tuple:
    """(abstract, concrete) train-state shapes of one rank: parameters,
    AdamW moments and the sampler's statistics."""
    from repro_torch.optim import make_optimizer
    from repro_torch.train import step

    cfg = _cfg("youtube-dnn")
    opt = make_optimizer("adamw", 1e-2)

    def shapes(state):
        return ({k: tuple(p.shape)
                 for k, p in state.params.named_parameters()},
                {k: tuple(v.shape)
                 for k, v in state.opt_state[1]["m"].items()},
                {k: tuple(v.shape)
                 for k, v in state.sampler_state.stats.items()})

    return (shapes(step.abstract_train_state(cfg, ctx, opt)),
            shapes(step.init_train_state(torch.Generator(), cfg, ctx, opt,
                                         device="cpu")))


def _raises(ctx, tmp: str) -> dict:
    """Each part left for later, and what it raised."""
    from repro_torch.data.pipeline import batch_iterator_for
    from repro_torch.optim import make_optimizer
    from repro_torch.sharding import rules
    from repro_torch.train import loop, step

    opt = make_optimizer("adamw", 1e-2)
    cfg = _cfg("youtube-dnn")
    state = step.init_train_state(torch.Generator().manual_seed(0), cfg, ctx,
                                  opt, device="cpu")
    cases = {
        "checkpoint": lambda: loop.fit(
            cfg, ctx, opt, batch_iterator_for(cfg, ctx, 16, 1,
                                              device="cpu"), 1,
            checkpoint_dir=tmp, device="cpu"),
        "seq_residuals": lambda: rules.mesh_ctx(ctx.mesh,
                                                seq_residuals=True),
        "experts": lambda: step.make_train_step(
            _cfg("dbrx-132b"), ctx, opt),
        "quantized index": lambda: step.export_quantized_index(state, cfg,
                                                              ctx),
        "checkpoint source": lambda: step.serving_index_source(
            tmp, cfg, ctx, opt, device="cpu"),
        **{f"family {name}": lambda name=name: step.make_train_step(
            _cfg(name), ctx, opt)
           for name in ("jamba-v0.1-52b", "deepseek-v3-671b")},
        "mtp": lambda: step.make_train_step(
            _cfg("llama3-8b", mtp=True), ctx, opt),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except Exception as e:  # noqa: BLE001 - the test reads the type
            out[name] = (type(e).__name__, str(e))
    out["head spec"] = state.params.param_specs["head_w"]
    return out


def _ported(ctx) -> dict:
    """What the head-only mesh refused and now runs: ``pure_fsdp``'s ctx,
    the backbone's specs (the abstract whole model's against the rank's
    state), a tied head's init and step, and an Adafactor step; each the
    loss it took, or the specs."""
    from repro_torch.data.pipeline import batch_iterator_for
    from repro_torch.models import api
    from repro_torch.optim import make_optimizer
    from repro_torch.sharding import rules
    from repro_torch.train import step

    cfg = _cfg("youtube-dnn")
    pure = rules.mesh_ctx(ctx.mesh, mode="pure_fsdp")
    out = {"pure_fsdp": (pure.mode, pure.tp_backbone, pure.dp)}
    lm = _cfg("llama3-8b", tie_embeddings=True)
    state = step.init_train_state(torch.Generator().manual_seed(0), lm, ctx,
                                  make_optimizer("adamw", 1e-2),
                                  device="cpu")
    whole = api.abstract_params(lm, ctx=ctx)
    out["backbone specs"] = (rules.param_specs_for(whole, ctx),
                             state.params.param_specs)
    _, metrics = step.make_train_step(lm, ctx, make_optimizer(
        "adamw", 1e-2))(state, next(batch_iterator_for(
            lm, ctx, 4, 8, device="cpu")), torch.Generator())
    out["tied head"] = float(metrics["loss"])
    ada = make_optimizer("adafactor", 1e-2)
    _, metrics = step.make_train_step(cfg, ctx, ada)(
        step.init_train_state(torch.Generator(), cfg, ctx, ada,
                              device="cpu"),
        next(batch_iterator_for(cfg, ctx, 16, 1, device="cpu")),
        torch.Generator())
    out["adafactor"] = float(metrics["loss"])
    # the tree, rff and midx statistics and the overlap island: one step
    # each
    opt = make_optimizer("adamw", 1e-2)
    for name, c in (
            *((f"sampler {s}", dataclasses.replace(cfg, sampler=s))
              for s in ("tree-quadratic", "rff", "midx")),
            ("overlap", dataclasses.replace(
                cfg, refresh_mode="overlap", sampler_refresh_every=4))):
        _, metrics = step.make_train_step(c, ctx, opt)(
            step.init_train_state(torch.Generator(), c, ctx, opt,
                                  device="cpu"),
            next(batch_iterator_for(c, ctx, 16, 1, device="cpu")),
            torch.Generator())
        out[name] = float(metrics["loss"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results and each mesh's ranks' results: the ranks
    start first, the reference's steps run here meanwhile, from the same
    initial parameters and batches (drawn by the port, as numpy)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.core.samplers import empty_state as jempty_state
    from repro.optim import make_optimizer as jmake_optimizer
    from repro.sharding.rules import local_ctx
    from repro.train import step as jstep
    from repro_torch import convert
    from repro_torch.data.pipeline import batch_iterator_for
    from repro_torch.models import api, transformer

    base = tmp_path_factory.mktemp("mesh_train")
    rng = np.random.default_rng(41)
    d = _cfg("youtube-dnn").tower_dims[-1]
    inp = {"head": (rng.normal(size=(VOCAB_R, d)) * 0.3).astype(np.float32),
           "proj": (rng.normal(size=(PROJ, d)) / np.sqrt(PROJ)).astype(
               np.float32),
           "tmp": str(base / "ckpt")}
    for name in STEP_CONFIGS:
        cfg = _cfg(name, estimator="full")
        for tp in TPS:  # a tree padded as init_lm pads it for tp_fsdp
            gen = torch.Generator().manual_seed(0)
            inp[f"{name}_params_tp{tp}"] = convert.params_to_jax(
                transformer.init_lm(gen, cfg, "cpu", tp=tp)
                if cfg.family == "dense" else
                api.init_params(cfg, gen, device="cpu"))
        inp[f"{name}_batch"] = _numpy(next(batch_iterator_for(
            cfg, None, *BATCH[name], seed=3, device="cpu")))
    started = start_meshes(_train_worker, base, inp)
    ref: dict = {}
    for name in STEP_CONFIGS:
        kw = {"vocab_size": 500} if name == "llama3-8b" else {}
        jcfg = jget_config(name).reduced(estimator="full", **kw)
        jopt = jmake_optimizer("adamw", **STEP_OPT)
        jfn = jax.jit(jstep.make_train_step(jcfg, local_ctx(), jopt))
        for tp in TPS:
            params = jax.tree_util.tree_map(jnp.asarray,
                                            inp[f"{name}_params_tp{tp}"])
            state = jstep.TrainState(
                params=params, opt_state=jopt.init(params),
                sampler_state=jempty_state(), step=jnp.zeros((), jnp.int32))
            new, metrics = jfn(state, inp[f"{name}_batch"],
                               jax.random.PRNGKey(1))
            ref[name, tp] = (float(metrics["loss"]),
                             jax.tree_util.tree_map(np.asarray, new.params))
    return inp, ref, {mesh: r.result() for mesh, r in started.items()}



def test_mesh_shape_for_matches_reference():
    from repro.launch.mesh import mesh_shape_for as jmesh_shape_for
    from repro_torch.launch.mesh import mesh_shape_for

    for devices in range(1, 17):
        for tp in range(0, 5):
            try:
                want = jmesh_shape_for(devices, tp)
            except ValueError as e:
                with pytest.raises(ValueError, match="does not divide"):
                    mesh_shape_for(devices, tp)
                assert "does not divide" in str(e)
                continue
            assert mesh_shape_for(devices, tp) == want


def test_validate_tp_checks():
    cfg = _cfg("youtube-dnn")
    cfg.validate(tp=4)
    with pytest.raises(ValueError, match="m_negatives=32 must divide"):
        cfg.validate(tp=3)
    with pytest.raises(ValueError, match="tapas_pool=128 must divide"):
        dataclasses.replace(cfg, sampler="tapas", m_negatives=24).validate(
            tp=3)
    with pytest.raises(ValueError, match="train_sharding"):
        dataclasses.replace(cfg, train_sharding="zero").validate()


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
@pytest.mark.parametrize("family", REFRESH_FAMILIES)
def test_sharded_refresh_matches_build_stats(runs, mesh, family):
    """Each shard's statistics against the reference's build on that
    shard's rows (padded to v_l) with its n_valid."""
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.core.samplers import sampler_from_config
    from repro_torch.sharding import rules

    inp, _, ranks = runs
    dp, tp = mesh
    cfg = _refresh_cfg(family)
    jcfg = jget_config("youtube-dnn").reduced(
        vocab_size=VOCAB_R, sampler=family, sampler_block=16,
        sampler_proj_rank=cfg.sampler_proj_rank)
    smp = sampler_from_config(jcfg)
    v_l = rules.vocab_shard(VOCAB_R, tp)
    pad = np.zeros((tp * v_l - VOCAB_R, inp["head"].shape[1]), np.float32)
    head = np.concatenate([inp["head"], pad])
    const = {"proj": jnp.asarray(inp["proj"])} if cfg.sampler_proj_rank \
        else {}
    for r, res in enumerate(ranks[mesh]):
        j = r % tp
        want = smp.build_stats(jnp.asarray(head[j * v_l:(j + 1) * v_l]),
                               rules.local_n_valid(VOCAB_R, v_l, j), const)
        got = res["refresh"][family]
        assert set(got) == set(want)
        for k in want:
            close(got[k], np.asarray(want[k]), what=f"{k} shard {j}")


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_batch_placement(runs, mesh):
    """Data rank i holds rows [i B/dp, (i + 1) B/dp) of the global batch;
    the ranks of one model column alike."""
    from repro_torch.data.pipeline import batch_iterator_for

    _, _, ranks = runs
    dp, tp = mesh
    data = batch_iterator_for(_cfg("youtube-dnn"), None, 8, 1, seed=4,
                              device="cpu")
    full = [next(data) for _ in range(2)]
    per = 8 // dp
    for r, res in enumerate(ranks[mesh]):
        i = r // tp
        for got, want in zip(res["batches"], full):
            for k, v in want.items():
                np.testing.assert_array_equal(
                    got[k], v[i * per:(i + 1) * per].numpy())


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
@pytest.mark.parametrize("name", STEP_CONFIGS)
def test_full_estimator_step_matches_unsharded(runs, mesh, name):
    """The mesh step's loss and every updated parameter against the
    reference's mesh=None step and the port's own mesh=None step."""
    inp, ref, ranks = runs
    dp, tp = mesh
    cfg = _cfg(name, estimator="full")
    want_loss, want_tree = ref[name, tp]
    want = _numpy(dict(_module(cfg, want_tree).named_parameters()))
    own_loss, own = _unsharded_step(cfg, inp[f"{name}_params_tp{tp}"],
                                    inp[f"{name}_batch"])
    close(own_loss, want_loss, what="the port's unsharded loss")
    for k, v in want.items():
        close(own[k], v, what=f"the port's unsharded {k}")
    for r, res in enumerate(ranks[mesh]):
        loss, params = res["steps"][name]
        close(loss, want_loss, what=f"rank {r} loss")
        close(loss, own_loss, what=f"rank {r} loss vs the port's")
        for k, v in want.items():  # gathered from the shards
            close(params[k][:v.shape[0]], v, what=f"rank {r} {k}")
            close(params[k][:v.shape[0]], own[k],
                  what=f"rank {r} {k} vs the port's")


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_sharded_clip_is_the_whole_models(runs, mesh):
    """Every rank clips by the whole model's norm: the head shards'
    squares summed once over the model group (a psum dropped or repeated
    moves the norm by a factor near tp), and the clipped shards are the
    whole clip's rows."""
    from repro_torch.optim.clip import clip_by_global_norm, global_norm

    _, _, ranks = runs
    dp, tp = mesh
    whole = _clip_grads()
    want_norm = float(global_norm(whole))
    assert want_norm > 1.0
    want, _ = clip_by_global_norm(1.0).update(
        {k: v.clone() for k, v in whole.items()}, (), None)
    want = _numpy(want)
    for r, res in enumerate(ranks[mesh]):
        norm, clipped = res["clip"]
        assert abs(norm - want_norm) <= 1e-6 * want_norm, (r, norm,
                                                           want_norm)
        for k in ("tower", "bias"):
            close(clipped[k], want[k], rtol=1e-6, what=f"rank {r} {k}")
    for i in range(dp):
        shards = np.concatenate([ranks[mesh][i * tp + j]["clip"][1]["head_w"]
                                 for j in range(tp)])
        close(shards[:VOCAB_R], want["head_w"], rtol=1e-6,
              what=f"data rank {i}'s head shards")


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
@pytest.mark.parametrize("family", FIT_FAMILIES)
def test_fit_on_the_mesh(runs, mesh, family):
    """Three fit steps: finite losses alike on every rank; every
    parameter gathered from the shards alike on every rank; each rank's
    head its (vocab / tp, d / dp) shard, its statistics its shard's."""
    from repro_torch.core.samplers import sampler_from_config

    _, _, ranks = runs
    dp, tp = mesh
    cfg = _cfg("youtube-dnn", sampler=family)
    losses0, params0, _, _ = ranks[mesh][0]["fit"][family]
    assert len(losses0) == FIT_STEPS and np.isfinite(losses0).all()
    shapes = sampler_from_config(cfg).shard_state_shapes(cfg, tp).stats
    for r, res in enumerate(ranks[mesh]):
        losses, params, stats, head = res["fit"][family]
        assert losses == losses0, (r, losses, losses0)
        for k, v in params.items():
            np.testing.assert_array_equal(v, params0[k], err_msg=k)
        assert head == (cfg.vocab_size // tp, cfg.tower_dims[-1] // dp)
        assert stats == {k: tuple(v.shape) for k, v in shapes.items()}


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_abstract_state_is_the_ranks_shard(runs, mesh):
    """``abstract_train_state`` on a mesh has the shapes
    ``init_train_state`` gives the rank: its shards, its moments, its
    statistics shard."""
    dp, tp = mesh
    cfg = _cfg("youtube-dnn")
    for res in runs[2][mesh]:
        abstract, concrete = res["abstract"]
        assert abstract == concrete
        assert concrete[0]["head_w"] == (cfg.vocab_size // tp,
                                         cfg.tower_dims[-1] // dp)
        # the reference's tower rule needs a path component before
        # "tower": its recsys tree's top-level tower stays whole
        assert concrete[0]["tower_w0"][0] == (
            cfg.d_model + cfg.user_feature_dim)
        assert concrete[2]["z"][0] == -(-cfg.vocab_size // tp //
                                        cfg.sampler_block)


#: cases of ``_raises`` that raised until expert parallelism and the
#: sequence-sharded residual stream were ported, and now pass the gates;
#: and the quantized index's export, which runs on the mesh since the
#: sharded quantized index was ported
PORTED_SINCE = ("seq_residuals", "experts", "family jamba-v0.1-52b",
                "family deepseek-v3-671b", "mtp", "quantized index")


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_parts_left_for_later_raise(runs, mesh):
    """Checkpoints on a mesh still raise naming A17; the ctx with
    ``seq_residuals``, experts, the hybrid family, MLA and mtp now build
    their train steps, and the quantized index exports."""
    _, _, ranks = runs
    for res in ranks[mesh]:
        raises = dict(res["raises"])
        assert raises.pop("head spec") == ("model", "data")
        for name in PORTED_SINCE:
            assert raises.pop(name) is None, name
        assert len(raises) == 2, raises
        for name, got in raises.items():
            assert got is not None, f"{name} did not raise"
            assert got[0] == "NotImplementedError" and "A17" in got[1], (
                name, got)


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_parts_ported_since_run(runs, mesh):
    """What the head-only mesh refused now runs: ``pure_fsdp``'s ctx (the
    batch over every rank, no backbone TP), the backbone's specs (a rank
    holds what ``param_specs_for`` gives the whole model), a head tied to
    the embedding and an Adafactor step; since then a step with each of
    the tree-quadratic, rff and midx samplers and with
    ``refresh_mode="overlap"`` (finite losses alike on every rank)."""
    dp, tp = mesh
    ranks = runs[2][mesh]
    for res in ranks:
        got = res["ported"]
        assert got["pure_fsdp"] == ("pure_fsdp", 1, dp * tp)
        want, held = got["backbone specs"]
        assert want == held
        assert want["segments.0.0.attn.wq"] == ("data", "model")
        for k in ("tied head", "adafactor", "sampler tree-quadratic",
                  "sampler rff", "sampler midx", "overlap"):
            assert np.isfinite(got[k]) and got[k] == ranks[0]["ported"][k]
