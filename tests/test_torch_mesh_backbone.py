"""The backbone's storage layouts on a (data, model) mesh
(``sharding/rules.py``, ``models/layers.py``, ``models/transformer.py``,
``train/step.py``, ``optim/clip.py``, ``optim/adafactor.py``,
``convert.py``) against the reference.

  * ``rules.param_specs_for`` equals ``repro.sharding.rules.
    param_specs_for`` on every leaf of every config's ``.reduced()`` tree,
    at (1, 4) and (2, 2), in all three modes (the reference's side over an
    ``AbstractMesh``: the function reads only axis sizes);
  * starcoder2-3b ``.reduced()`` (4 / 2 heads; fp32) on gloo ranks
    (``torch_mesh_util``) in ``tp_fsdp`` at (1, 4) (KV heads padded to 4)
    and (2, 2) and in ``pure_fsdp`` at both: each rank's hidden states,
    the loss and every gradient shard against the reference's
    single-host ``jax.jit`` results on the same tree (padded by
    ``padded_heads`` for tp_fsdp), within 1e-5 of max; the same with a
    head tied to the embedding;
  * one AdamW and one Adafactor step (clip included): the updated shards
    against the slices of the port's unsharded update, within 1e-5;
  * ``shard_by_spec`` / ``gather_by_spec`` and ``convert``'s train state
    onto a rank's shards and back, bitwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from torch_mesh_util import close, mesh_id, start_meshes

torch.set_num_threads(1)

MESHES = ((1, 4), (2, 2))
MODES = ("tp_fsdp", "pure_fsdp")
SPEC_MODES = ("tp_fsdp", "pure_fsdp", "tp")
B, S = 8, 8
FIT_STEPS = 2
#: AdamW's eps at 1e-3, as the port's step tests set it: it normalises
#: each element by its own statistics, so at its default an element whose
#: gradient is near 0 (a k bias: only RoPE keeps its gradient from
#: cancelling) turns the summation-order noise of a sharded sum (~1e-6 of
#: the leaf's max) into an update of the learning rate's size.  Adafactor
#: (``_optimizer``) at the reference's eps 1e-30 on the matrices, whose
#: row and column means of g^2 (psum'd where the other dim is sharded) sit
#: far above it, and at 1e-6 (a floor of 1e-3 under |g|) on the vectors,
#: whose statistics are those few elements' own squares: the same noise
#: trap as AdamW's
STEP_OPTS = {"adamw": dict(lr=1e-2, eps=1e-3),
             "adafactor": dict(lr=1e-2, eps=1e-30, vector_eps=1e-6)}
#: the families that train on a mesh
MESH_FAMILIES = ("recsys", "lstm", "dense", "ssm", "encdec")
CONFIGS = ("youtube-dnn", "ptb-lstm", "llama3-8b", "starcoder2-3b",
           "mistral-nemo-12b", "qwen2-72b", "chameleon-34b", "dbrx-132b",
           "deepseek-v3-671b", "falcon-mamba-7b", "jamba-v0.1-52b",
           "whisper-large-v3")


def _cfg(tie: bool = False):
    from repro_torch.configs import get_config

    return get_config("starcoder2-3b").reduced(estimator="full",
                                               tie_embeddings=tie)


def _tp_backbone(mesh, mode: str) -> int:
    return 1 if mode == "pure_fsdp" else mesh[1]


def _tree(tie: bool, tp_b: int) -> dict:
    """The reference-form tree (numpy) of starcoder2-3b reduced, heads
    padded for a backbone of TP degree tp_b (the vocab divides)."""
    from repro_torch import convert
    from repro_torch.models import transformer

    return convert.params_to_jax(transformer.init_lm(
        torch.Generator().manual_seed(0), _cfg(tie), "cpu", tp=tp_b))


def _module(cfg, tree_np):
    from repro_torch import convert
    from repro_torch.models.transformer import StackedLM

    return StackedLM(cfg, "cpu", tree=convert.params_from_jax(
        tree_np, cfg, device="cpu"))


def _capture():
    """A transform that keeps the gradients it is given and updates
    nothing."""
    from repro_torch.optim.transform import GradientTransform

    got: dict = {}

    def update(grads, state, params):
        got.update({k: g.detach().clone() for k, g in grads.items()})
        return {}, state

    return GradientTransform(lambda params: (), update), got


def _by_ndim(matrices, vectors):
    """A transform that runs ``matrices`` on the leaves of two or more
    dims and ``vectors`` on the rest (a mesh rank's ``ShardedGrads``
    split alike)."""
    from repro_torch.optim.clip import ShardedGrads
    from repro_torch.optim.transform import GradientTransform

    def split(d, params):
        mat = {k: v for k, v in d.items() if params[k].dim() >= 2}
        vec = {k: v for k, v in d.items() if k not in mat}
        if isinstance(d, ShardedGrads):
            return tuple(ShardedGrads(x, d.specs, d.ctx) for x in (mat, vec))
        return mat, vec

    def init(params):
        return tuple(t.init(x) for t, x in zip((matrices, vectors),
                                               split(params, params)))

    def update(grads, state, params):
        out = [t.update(g, s, p) for t, g, s, p in zip(
            (matrices, vectors), split(grads, params), state,
            split(params, params))]
        return {**out[0][0], **out[1][0]}, (out[0][1], out[1][1])

    return GradientTransform(init, update)


def _optimizer(name: str):
    """clip + ``name`` at STEP_OPTS (Adafactor's eps by leaf: see there)."""
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.adafactor import adafactor
    from repro_torch.optim.clip import clip_by_global_norm
    from repro_torch.optim.transform import chain

    kw = dict(STEP_OPTS[name])
    if name != "adafactor":
        return make_optimizer(name, **kw)
    vector_eps = kw.pop("vector_eps")
    return chain(clip_by_global_norm(1.0), _by_ndim(
        adafactor(**kw), adafactor(**{**kw, "eps": vector_eps})))


def _numpy(named: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in named.items()}


def _block(x: np.ndarray, spec, mesh, rank: int) -> np.ndarray:
    """Rank ``rank``'s block of a whole array by ``spec`` on a (dp, tp)
    mesh (``rules.shard_by_spec``'s arithmetic)."""
    dp, tp = mesh
    pos = {"data": (rank // tp, dp), "model": (rank % tp, tp)}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = 0, 1
        for a in ((entry,) if isinstance(entry, str) else entry):
            idx, n = idx * pos[a][1] + pos[a][0], n * pos[a][1]
        size = x.shape[dim] // n
        x = np.take(x, range(idx * size, (idx + 1) * size), axis=dim)
    return x


# --- ranks ------------------------------------------------------------------


def _worker(ctx, inp: dict) -> dict:
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import distributed
    from repro_torch.data.pipeline import batch_iterator_for
    from repro_torch.models import transformer
    from repro_torch.optim import make_optimizer
    from repro_torch.sharding import rules
    from repro_torch.train import loop, step

    out: dict = {}
    mesh = ctx.mesh
    batch_np = inp["batch"]
    for mode in MODES:
        mctx = rules.mesh_ctx(mesh, mode=mode)
        tp_b = mctx.tp_backbone
        batch = {k: rules.batch_rows(torch.from_numpy(v.copy()), mctx)
                 for k, v in batch_np.items()}
        for tie in (False, True):
            cfg = _cfg(tie)
            model = step.shard_params(
                _module(cfg, inp[f"tree_{tie}_{tp_b}"]), cfg, mctx)
            h, _ = transformer.hidden_states(model, batch["tokens"], cfg,
                                             mctx)
            opt, got = _capture()
            state = step.TrainState(model, (), step.empty_state(), 0)
            _, metrics = step.make_train_step(cfg, mctx, opt)(
                state, batch, torch.Generator().manual_seed(1))
            out[mode, tie] = {"h": h.detach().numpy(),
                              "loss": float(metrics["loss"]),
                              "grads": _numpy(got),
                              "specs": dict(model.param_specs),
                              "block": mctx.batch_index}
        cfg = _cfg()
        for name in STEP_OPTS:
            opt = _optimizer(name)
            model = step.shard_params(
                _module(cfg, inp[f"tree_False_{tp_b}"]), cfg, mctx)
            state = step.TrainState(model, opt.init(step.param_dict(model)),
                                    step.empty_state(), 0)
            _, metrics = step.make_train_step(cfg, mctx, opt)(
                state, batch, torch.Generator().manual_seed(1))
            out[mode, name] = {"loss": float(metrics["loss"]),
                               "params": _numpy(step.param_dict(model))}
        # the reference's tree and Adafactor's state onto the shards and
        # back (a state of random moments, so nothing is zero)
        np_params, np_opt = inp[f"tree_False_{tp_b}"], inp["ada_state"][tp_b]
        shard = convert.train_state_from_jax(
            np_params, np_opt, {"stats": {}, "const": {}}, 3, cfg,
            device="cpu", ctx=mctx)
        back = convert.train_state_to_jax(shard, cfg, mctx)
        out[mode, "convert"] = {
            "shapes": {k: tuple(p.shape)
                       for k, p in shard.params.named_parameters()},
            "back": back[:2]}
        # fit takes the mode from the config, whatever the ctx's
        fcfg = get_config("starcoder2-3b").reduced(train_sharding=mode)
        opt = make_optimizer("adamw", 1e-2)
        res = loop.fit(fcfg, ctx, opt, batch_iterator_for(
            fcfg, ctx, B, S, device="cpu"), FIT_STEPS, log_every=0,
            device="cpu")

        def shapes(state):
            return ({k: tuple(p.shape)
                     for k, p in state.params.named_parameters()},
                    {k: tuple(v.shape)
                     for k, v in state.opt_state[1]["m"].items()})

        out[mode, "fit"] = (res.losses, shapes(res.state), shapes(
            step.abstract_train_state(fcfg, mctx, opt)))
    spec = ("data", "model")
    x = torch.arange(24 * 8, dtype=torch.float32).reshape(24, 8)
    part = rules.shard_by_spec(x, spec, ctx)
    flat = rules.shard_by_spec(x, (("data", "model"), None), ctx)
    out["spec round trip"] = (
        part.numpy(), rules.gather_by_spec(part, spec, ctx).numpy(),
        flat.numpy(),
        rules.gather_by_spec(flat, (("data", "model"), None), ctx).numpy())
    rank = ctx.batch_index + 1  # the tp_fsdp ctx: its data position
    out["reduce scatter"] = distributed.reduce_scatter_tiled(
        x * rank, ctx.model_group, dim=1).numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks (started first), then here: the reference's
    single-host hidden states, loss and gradients of each tree under
    ``jax.jit``, and the port's unsharded AdamW and Adafactor steps."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.core import estimators as jest
    from repro.models import api as japi
    from repro.sharding.rules import local_ctx
    from repro_torch import convert
    from repro_torch.optim import make_optimizer
    from repro_torch.train import step

    rng = np.random.default_rng(30)
    cfg = _cfg()
    inp = {"batch": {
        "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64),
        "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)},
        "ada_state": {}}
    tps = (1, 2, 4)
    for tie in (False, True):
        for tp_b in tps:
            inp[f"tree_{tie}_{tp_b}"] = _tree(tie, tp_b)
    for tp_b in tps:
        model = _module(cfg, inp[f"tree_False_{tp_b}"])
        ada = make_optimizer("adafactor", 1e-2).init(step.param_dict(model))
        gen = torch.Generator().manual_seed(tp_b)
        ada = convert._map_tree(lambda t: torch.rand(
            t.shape, generator=gen) if t.dim() else t, ada)
        state = step.TrainState(model, ada, step.empty_state(), 0)
        inp["ada_state"][tp_b] = convert.train_state_to_jax(state)[1]
    started = start_meshes(_worker, tmp_path_factory.mktemp("backbone"),
                           inp, meshes=MESHES)

    ref: dict = {}
    batch_j = {k: jnp.asarray(v.astype(np.int32))
               for k, v in inp["batch"].items()}
    for tie in (False, True):
        jcfg = jget_config("starcoder2-3b").reduced(estimator="full",
                                                    tie_embeddings=tie)
        est = jest.make_estimator("full")

        def jloss(params, jcfg=jcfg, est=est):
            hh, lab, _ = japi.backbone_hidden(params, batch_j, jcfg,
                                              local_ctx())
            losses = jest.loss_from_embeddings(
                est, japi.head_table(params, jcfg), hh, lab, None, None,
                abs_mode=jcfg.abs_softmax)
            return jnp.mean(losses), hh

        fn = jax.jit(jax.value_and_grad(jloss, has_aux=True))
        for tp_b in tps:
            params = jax.tree_util.tree_map(jnp.asarray,
                                            inp[f"tree_{tie}_{tp_b}"])
            (loss, hh), grads = fn(params)
            gmod = _module(_cfg(tie), jax.tree_util.tree_map(np.asarray,
                                                             grads))
            ref[tie, tp_b] = {"loss": float(loss),
                              "h": np.asarray(hh).reshape(B, S, -1),
                              "grads": _numpy(dict(
                                  gmod.named_parameters()))}
    for tp_b in tps:
        for name in STEP_OPTS:
            opt = _optimizer(name)
            model = _module(cfg, inp[f"tree_False_{tp_b}"])
            state = step.TrainState(model, opt.init(step.param_dict(model)),
                                    step.empty_state(), 0)
            _, metrics = step.make_train_step(cfg, None, opt)(
                state, {k: torch.from_numpy(v.copy())
                        for k, v in inp["batch"].items()},
                torch.Generator().manual_seed(1))
            ref[name, tp_b] = {"loss": float(metrics["loss"]),
                               "params": _numpy(step.param_dict(model))}
    return inp, ref, {mesh: r.result() for mesh, r in started.items()}


# --- param_specs_for against the reference ----------------------------------


class _SizesOnly:
    """What ``rules.ShardCtx`` reads of a mesh for specs: its dims'
    names and sizes."""

    mesh_dim_names = ("data", "model")

    def __init__(self, dp: int, tp: int):
        self._sizes = (dp, tp)

    def size(self, dim: int) -> int:
        return self._sizes[dim]

    def get_local_rank(self, axis: str) -> int:
        return 0


def _ref_leaves(jcfg, jctx) -> dict:
    """The reference's tree (shapes only) and specs, by '/'-path."""
    import jax

    from repro.models import api as japi
    from repro.sharding.rules import param_specs_for as jspecs

    shapes = jax.eval_shape(
        lambda k: japi.init_params(k, jcfg, jctx, max_len=64),
        jax.random.PRNGKey(0))
    specs = jspecs(shapes, jctx)

    def path(p):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in p)

    flat_s = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat_p = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {path(p): (leaf.shape, tuple(spec))
            for (p, leaf), spec in zip(flat_s, flat_p)}


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
@pytest.mark.parametrize("name", CONFIGS)
def test_param_specs_match_reference(name, mesh):
    """Every leaf of the port's module (on the meta device) gets the
    reference's spec of its path, in every mode; the whole shapes of the
    families that train on a mesh are the reference's at the mesh's
    padding."""
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jget_config
    from repro.sharding.rules import mesh_ctx as jmesh_ctx
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.sharding import rules

    dp, tp = mesh
    cfg = get_config(name).reduced()
    jcfg = jget_config(name).reduced()
    for mode in SPEC_MODES:
        ctx = rules.ShardCtx(mesh=_SizesOnly(dp, tp), mode=mode)
        jctx = jmesh_ctx(AbstractMesh((dp, tp), ("data", "model")), mode)
        want = _ref_leaves(jcfg, jctx)
        if cfg.family in MESH_FAMILIES:
            module = api.abstract_params(cfg, max_len=64, ctx=ctx)
        else:
            module = api.abstract_params(cfg, max_len=64)
        names = [k for k, _ in module.named_parameters()]
        seen = set()
        for k in names:
            path = rules.ref_path(k)
            shape, spec = want[path]
            stacked = rules._LAYER.match(k) is not None
            if stacked:  # a layer's view: the stack's spec, its layer dim
                shape, spec = shape[1:], spec[1:]
            spec = spec + (None,) * (len(shape) - len(spec))
            got = rules.spec_for(k, shape, ctx)
            assert got == spec, (mode, k, got, spec)
            if cfg.family in MESH_FAMILIES:
                assert tuple(module.get_parameter(k).shape) == shape, (
                    mode, k)
            seen.add(path)
        assert seen == set(want), (mode, set(want) - seen)
        if cfg.family in MESH_FAMILIES:
            specs = rules.param_specs_for(module, ctx)
            assert specs == {k: rules.spec_for(
                k, module.get_parameter(k).shape, ctx) for k in names}


# --- the starcoder2-3b ranks --------------------------------------------------


@pytest.mark.parametrize("tie", (False, True), ids=("untied", "tied"))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_hidden_loss_and_gradient_shards(runs, mesh, mode, tie):
    """Each rank's h rows, the loss and every gradient shard equal the
    reference's single-host results on the same tree (its heads padded
    for the mesh's backbone), fp32 within 1e-5 of max."""
    inp, ref, ranks = runs
    tp_b = _tp_backbone(mesh, mode)
    want = ref[tie, tp_b]
    per = B // (mesh[0] * (mesh[1] if mode == "pure_fsdp" else 1))
    for r, res in enumerate(ranks[mesh]):
        got = res[mode, tie]
        i = got["block"]
        close(got["h"], want["h"][i * per:(i + 1) * per],
              what=f"rank {r} h")
        close(got["loss"], want["loss"], what=f"rank {r} loss")
        assert set(got["grads"]) == set(want["grads"])
        for k, g in got["grads"].items():
            whole = want["grads"][k]
            block = _block(whole, got["specs"][k], mesh, r)
            assert g.shape == block.shape, (k, got["specs"][k])
            # within 1e-5 of the WHOLE gradient's max
            assert np.abs(g - block).max() <= 1e-5 * np.abs(whole).max(), (
                r, k)


@pytest.mark.parametrize("opt", tuple(STEP_OPTS))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_optimizer_step_on_shards(runs, mesh, mode, opt):
    """One clip + AdamW or clip + Adafactor step on the shards: every
    updated shard equals its slice of the port's unsharded update (the
    clip's norm and Adafactor's statistics over the whole leaf), fp32
    within 1e-5 of the parameter's max."""
    _, ref, ranks = runs
    want = ref[opt, _tp_backbone(mesh, mode)]
    for r, res in enumerate(ranks[mesh]):
        got = res[mode, opt]
        specs = res[mode, False]["specs"]
        close(got["loss"], want["loss"], what=f"rank {r} loss")
        for k, p in got["params"].items():
            whole = want["params"][k]
            block = _block(whole, specs[k], mesh, r)
            scale = np.abs(whole).max()
            assert p.shape == block.shape
            assert np.abs(p - block).max() <= 1e-5 * scale, (r, k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_convert_round_trip_is_bitwise(runs, mesh, mode):
    """The reference's params and Adafactor state go onto each rank's
    shards (the shapes ``param_specs_for`` gives) and gather back to the
    same bits."""
    import jax

    inp, _, ranks = runs
    tp_b = _tp_backbone(mesh, mode)
    for r, res in enumerate(ranks[mesh]):
        got = res[mode, "convert"]
        specs = res[mode, False]["specs"]
        for k, shape in got["shapes"].items():
            n = {"data": mesh[0], "model": mesh[1]}
            want = list(_module(_cfg(), inp[f"tree_False_{tp_b}"])
                        .get_parameter(k).shape)
            for d, entry in enumerate(specs[k]):
                for a in ((entry,) if isinstance(entry, str)
                          else entry or ()):
                    want[d] //= n[a]
            assert shape == tuple(want), (k, specs[k])
        for got_t, want_t in ((got["back"][0], inp[f"tree_False_{tp_b}"]),
                              (got["back"][1], inp["ada_state"][tp_b])):
            g = jax.tree_util.tree_leaves(got_t)
            w = jax.tree_util.tree_leaves(want_t)
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_fit_takes_the_configs_mode(runs, mesh, mode):
    """``fit`` with the sampled loss (batch-shared negatives) on a mesh
    ctx of tp_fsdp trains in ``cfg.train_sharding``: finite losses alike
    on every rank, each rank's parameters and AdamW moments the shards
    ``abstract_train_state`` gives it in that mode."""
    ranks = runs[2][mesh]
    losses0 = ranks[0][mode, "fit"][0]
    assert len(losses0) == FIT_STEPS and np.isfinite(losses0).all()
    dp, tp = mesh
    for r, res in enumerate(ranks):
        losses, concrete, abstract = res[mode, "fit"]
        assert losses == losses0, (r, losses, losses0)
        assert concrete == abstract
        wq = concrete[0]["segments.0.0.attn.wq"]
        # F over data in both modes; M over model (stored so in pure_fsdp)
        assert wq == (64 // dp, 4 * 16 // tp), wq


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_shard_and_gather_by_spec(runs, mesh):
    """``shard_by_spec`` slices each dim by its axes (a tuple of axes
    data-major), ``gather_by_spec`` gives the whole back, bitwise;
    ``reduce_scatter_tiled`` sums over the group and keeps this rank's
    slice."""
    dp, tp = mesh
    x = np.arange(24 * 8, dtype=np.float32).reshape(24, 8)
    for r, res in enumerate(runs[2][mesh]):
        part, whole, flat, flat_whole = res["spec round trip"]
        i, j = divmod(r, tp)
        np.testing.assert_array_equal(
            part, x[i * 24 // dp:(i + 1) * 24 // dp,
                    j * 8 // tp:(j + 1) * 8 // tp])
        np.testing.assert_array_equal(flat, x[r * 24 // (dp * tp):
                                              (r + 1) * 24 // (dp * tp)])
        np.testing.assert_array_equal(whole, x)
        np.testing.assert_array_equal(flat_whole, x)
        # the model column's sum, this rank's columns (data position + 1
        # scales each rank's part)
        np.testing.assert_array_equal(
            res["reduce scatter"],
            x[:, j * 8 // tp:(j + 1) * 8 // tp] * tp * (i + 1))


def test_family_gates_name_a17():
    """Every family passes the mesh's family gate: the hybrid and moe
    configs (MLA and the mtp block included, since expert parallelism
    was ported: ``test_torch_mesh_experts.py``), mtp on a dense config, a
    tied or untied dense config and recsys (the lstm, ssm and encdec
    families too: ``test_torch_mesh_families.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import api

    for name in ("jamba-v0.1-52b", "deepseek-v3-671b", "dbrx-132b"):
        api.require_mesh_layout(get_config(name).reduced())
    api.require_mesh_layout(dataclasses.replace(
        get_config("llama3-8b").reduced(), mtp=True))
    for name in ("youtube-dnn", "starcoder2-3b", "llama3-8b"):
        api.require_mesh_layout(get_config(name).reduced(
            tie_embeddings=name != "youtube-dnn"))
