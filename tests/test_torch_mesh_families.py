"""The ssm, encdec and lstm families' storage layouts on a (data, model)
mesh (``models/mamba.py``, ``models/transformer.py``,
``models/encdec.py``, ``models/lstm_lm.py``, ``models/api.py``,
``train/step.py``, ``convert.py``) against the reference.

On gloo ranks (``torch_mesh_util``) at (1, 2), (2, 2) and (1, 4), in
``tp_fsdp`` and ``pure_fsdp``, for falcon-mamba-7b, whisper-large-v3 (its
vocab 510, so the head's padding to 512 at tp 4 is exercised) and
ptb-lstm, each ``.reduced()`` in fp32:

  * each rank's hidden states, the full-softmax loss and every gradient
    shard against the reference's single-host ``jax.jit`` results on the
    same tree (padded as ``init_encdec(..., ctx=)`` pads it), within 1e-5
    of each whole gradient's max;
  * one clip + AdamW (eps 1e-3) and clip + Adafactor (eps by leaf, as
    ``test_torch_mesh_backbone.py``) step at the full softmax's fixed
    negatives (every class): the updated shards against the port's
    unsharded update;
  * ``convert``'s train state onto the rank's shards and back, bitwise
    (ptb-lstm at vocab 510, its tables padded at tp 4);
  * ``fit`` in each mode: losses alike on every rank, the rank's shards
    as ``abstract_train_state`` gives them;
  * the mamba block alone, channel-parallel over the model group, its
    output and every leaf's gradient against the reference's
    ``apply_mamba``, and the same block with the backward all-reduce of
    ``x_proj``'s sum taken out, which must miss.

The refusals that stay (shard checkpoints, the 3-D mesh) are held here
too, beside the gates that MLA / mtp, the hybrid family, experts and
every family's serving now pass.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from torch_mesh_util import MESHES, close, mesh_id, start_meshes

torch.set_num_threads(1)

MODES = ("tp_fsdp", "pure_fsdp")
FAMILIES = ("falcon-mamba-7b", "whisper-large-v3", "ptb-lstm")
B, S, SF = 8, 8, 12
MAX_LEN = 16
#: whisper's reduced vocab: not a multiple of 4, so tp 4 pads it
WHISPER_VOCAB = 510
FIT_STEPS = 2
#: as ``test_torch_mesh_backbone.STEP_OPTS`` (see there)
STEP_OPTS = {"adamw": dict(lr=1e-2, eps=1e-3),
             "adafactor": dict(lr=1e-2, eps=1e-30, vector_eps=1e-6)}
#: the mamba block alone: its batch and sequence
BLOCK_B, BLOCK_S = 4, 12


def _cfg(name: str, estimator: str = "full", **changes):
    from repro_torch.configs import get_config

    if name == "whisper-large-v3":
        changes.setdefault("vocab_size", WHISPER_VOCAB)
    return get_config(name).reduced(estimator=estimator, **changes)


def _tp_backbone(mesh, mode: str) -> int:
    return 1 if mode == "pure_fsdp" else mesh[1]


def _variant(name: str, mesh, mode: str) -> tuple[int, int]:
    """The tree a (mesh, mode) trains: (the head's tp its vocab is padded
    to, the backbone's tp its heads are padded to); (1, 1) where neither
    pads."""
    if name != "whisper-large-v3":
        return (1, 1)
    return (mesh[1], _tp_backbone(mesh, mode))


def _tree(name: str, variant: tuple[int, int], vocab: int | None = None
          ) -> dict:
    """The reference-form tree (numpy) of a family's reduced config: its
    heads padded for a backbone of tp ``variant[1]``, its vocab padded
    with zero rows to a multiple of ``variant[0]``."""
    from repro_torch import convert
    from repro_torch.models import encdec, lstm_lm, transformer
    from repro_torch.sharding import rules

    cfg = _cfg(name, **({} if vocab is None else {"vocab_size": vocab}))
    gen = torch.Generator().manual_seed(31)
    tp_v, tp_b = variant
    if cfg.family == "encdec":
        tree = encdec.init_encdec(gen, cfg, "cpu", tp=tp_b, max_len=MAX_LEN)
        tree["embed"]["table"] = rules.pad_rows(tree["embed"]["table"], tp_v)
        tree["head"]["w"] = rules.pad_rows(tree["head"]["w"], tp_v)
        return convert.params_to_jax(tree)
    if cfg.family == "lstm":
        return convert.params_to_jax(lstm_lm.init_lstm_lm(gen, cfg, "cpu"))
    return convert.params_to_jax(transformer.init_lm(gen, cfg, "cpu"))


def _module(cfg, tree_np):
    """The port's training module of a reference-form tree."""
    from repro_torch import convert
    from repro_torch.models import api

    got = convert.params_from_jax(tree_np, cfg, device="cpu")
    if isinstance(got, dict):
        return api.PARAM_MODULES[cfg.family](cfg, "cpu", tree=got)
    return got


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
    """``matrices`` on the leaves of two or more dims, ``vectors`` on the
    rest (a mesh rank's ``ShardedGrads`` split alike)."""
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
    """clip + ``name`` at STEP_OPTS (Adafactor's eps by leaf)."""
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


def _batch(cfg, rng) -> dict:
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
           "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((B, SF, cfg.d_model)).astype(
            np.float32)
    return out


def _random_moments(cfg, tree_np, opt_name: str, seed: int):
    """The reference form of ``opt_name``'s state of a tree, every moment
    drawn uniform (so nothing is zero)."""
    from repro_torch import convert
    from repro_torch.optim import make_optimizer
    from repro_torch.train import step

    model = _module(cfg, tree_np)
    state = make_optimizer(opt_name, 1e-2).init(step.param_dict(model))
    gen = torch.Generator().manual_seed(seed)
    state = convert._map_tree(lambda t: torch.rand(
        t.shape, generator=gen) if t.dim() else t, state)
    return convert.train_state_to_jax(step.TrainState(
        model, state, step.empty_state(), 0))[1]


# --- ranks ------------------------------------------------------------------


def _mamba_block(ctx, inp: dict, mutate: bool) -> dict:
    """The mamba block alone on this rank, channel-parallel over the
    model group (tp_fsdp): its output rows and every leaf's gradient shard
    (summed over the batch axes as the train step sums them) and dL/dx.
    ``mutate`` takes the backward all-reduce out of ``x_proj``'s sum (a
    psum whose backward is the identity)."""
    from repro_torch.core import distributed
    from repro_torch.models import mamba as M
    from repro_torch.sharding import rules

    cfg = _cfg("falcon-mamba-7b")
    specs = {k: rules.spec_for(f"segments.0.0.mamba.{k}", v.shape, ctx)
             for k, v in inp["mamba"].items()}
    group = rules.tp_group(ctx)
    shards = {k: rules.shard_by_spec(torch.from_numpy(v), specs[k], ctx)
              .requires_grad_() for k, v in inp["mamba"].items()}
    x = rules.batch_rows(torch.from_numpy(inp["mamba_x"]), ctx).clone()
    x.requires_grad_()
    ct = rules.batch_rows(torch.from_numpy(inp["mamba_ct"]), ctx)
    ssm_params = M._ssm_params

    def psum_only(p, xc, cfg_, group_=None):
        replicated = distributed.replicated
        distributed.replicated = lambda t, g: t
        try:
            return ssm_params(p, xc, cfg_, group_)
        finally:
            distributed.replicated = replicated

    if mutate:
        M._ssm_params = psum_only
    try:
        y = M.apply_mamba(M.mesh_view(shards, specs, ctx, group), x, cfg,
                          group=group)
        torch.sum(y * ct).backward()
    finally:
        M._ssm_params = ssm_params
    grads = {}
    for k, p in shards.items():
        axes = rules.grad_reduce_axes(specs[k], ctx)
        g = p.grad
        if axes:
            distributed.all_reduce_(g, "sum", ctx.group(axes))
        grads[k] = g.numpy().copy()
    return {"y": y.detach().numpy(), "x_grad": x.grad.numpy(),
            "grads": grads, "specs": specs, "block": ctx.batch_index}


def _worker(ctx, inp: dict) -> dict:
    from repro_torch import convert
    from repro_torch.data.pipeline import batch_iterator_for
    from repro_torch.models import api
    from repro_torch.optim import make_optimizer
    from repro_torch.sharding import rules
    from repro_torch.train import loop, step

    out: dict = {}
    mesh = ctx.mesh
    dp, tp = ctx.axis_size("data"), ctx.tp
    for mode in MODES:
        mctx = rules.mesh_ctx(mesh, mode=mode)
        for name in FAMILIES:
            cfg = _cfg(name)
            var = _variant(name, (dp, tp), mode)
            tree = inp["trees"][name, var]
            batch = {k: rules.batch_rows(torch.from_numpy(v.copy()), mctx)
                     for k, v in inp["batch"][name].items()}
            model = step.shard_params(_module(cfg, tree), cfg, mctx)
            h, _, _ = api.backbone_hidden(model, batch, cfg, mctx)
            opt, got = _capture()
            state = step.TrainState(model, (), step.empty_state(), 0)
            _, metrics = step.make_train_step(cfg, mctx, opt)(
                state, batch, torch.Generator().manual_seed(1))
            out[mode, name] = {"h": h.detach().reshape(-1, S, h.shape[-1])
                               .numpy(),
                               "loss": float(metrics["loss"]),
                               "grads": _numpy(got),
                               "specs": dict(model.param_specs),
                               "block": mctx.batch_index}
            for opt_name in STEP_OPTS:
                opt = _optimizer(opt_name)
                model = step.shard_params(_module(cfg, tree), cfg, mctx)
                state = step.TrainState(
                    model, opt.init(step.param_dict(model)),
                    step.empty_state(), 0)
                _, metrics = step.make_train_step(cfg, mctx, opt)(
                    state, batch, torch.Generator().manual_seed(1))
                out[mode, name, opt_name] = {
                    "loss": float(metrics["loss"]),
                    "params": _numpy(step.param_dict(model))}
            # the train state onto the shards and back (ptb-lstm at its
            # convert vocab: padded at tp 4)
            ccfg = _cfg(name, **({"vocab_size": WHISPER_VOCAB}
                                 if name == "ptb-lstm" else {}))
            ctree = inp["convert trees"][name, var]
            for opt_name in STEP_OPTS:
                shard = convert.train_state_from_jax(
                    ctree, inp["opt states"][name, var, opt_name],
                    {"stats": {}, "const": {}}, 3, ccfg, device="cpu",
                    ctx=mctx)
                back = convert.train_state_to_jax(shard, ccfg, mctx)
                out[mode, name, "convert", opt_name] = {
                    "shapes": {k: tuple(p.shape)
                               for k, p in shard.params.named_parameters()},
                    "specs": dict(shard.params.param_specs),
                    "back": back[:2]}
            # fit takes the mode from the config, whatever the ctx's
            fcfg = _cfg(name, estimator="sampled-softmax",
                        train_sharding=mode)
            fopt = make_optimizer("adamw", 1e-2)
            res = loop.fit(fcfg, ctx, fopt, batch_iterator_for(
                fcfg, ctx, B, S, device="cpu"), FIT_STEPS, log_every=0,
                device="cpu", max_len=MAX_LEN)

            def shapes(state):
                return ({k: tuple(p.shape)
                         for k, p in state.params.named_parameters()},
                        {k: tuple(v.shape)
                         for k, v in state.opt_state[1]["m"].items()})

            out[mode, name, "fit"] = (res.losses, shapes(res.state), shapes(
                step.abstract_train_state(fcfg, mctx, fopt,
                                          max_len=MAX_LEN)))
    for mutate in (False, True):
        out["mamba block", mutate] = _mamba_block(ctx, inp, mutate)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks (started first), then here: the reference's
    single-host hidden states, loss and gradients of each tree under
    ``jax.jit``, the reference's mamba block and its gradients, and the
    port's unsharded AdamW and Adafactor steps."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.core import estimators as jest
    from repro.models import api as japi
    from repro.models import mamba as jmamba
    from repro.sharding.rules import local_ctx
    from repro_torch.models import mamba as M
    from repro_torch.train import step

    rng = np.random.default_rng(31)
    variants = {name: sorted({_variant(name, mesh, mode) for mesh in MESHES
                              for mode in MODES}) for name in FAMILIES}
    inp = {"batch": {name: _batch(_cfg(name), rng) for name in FAMILIES},
           "trees": {}, "convert trees": {}, "opt states": {}}
    for name in FAMILIES:
        for var in variants[name]:
            inp["trees"][name, var] = _tree(name, var)
            if name == "ptb-lstm":
                ctree = _tree(name, var, vocab=WHISPER_VOCAB)
                ccfg = _cfg(name, vocab_size=WHISPER_VOCAB)
            else:
                ctree, ccfg = inp["trees"][name, var], _cfg(name)
            inp["convert trees"][name, var] = ctree
            for i, opt_name in enumerate(STEP_OPTS):
                inp["opt states"][name, var, opt_name] = _random_moments(
                    ccfg, ctree, opt_name, seed=i)
    mcfg = _cfg("falcon-mamba-7b")
    inp["mamba"] = {k: v.numpy() for k, v in M.init_mamba_full(
        torch.Generator().manual_seed(32), mcfg, "cpu").items()}
    # a nonzero conv bias and a spread of dt biases and D
    inp["mamba"]["conv_b"] = rng.standard_normal(
        inp["mamba"]["conv_b"].shape).astype(np.float32) * 0.1
    inp["mamba"]["dt_bias"] += rng.standard_normal(
        inp["mamba"]["dt_bias"].shape).astype(np.float32)
    inp["mamba"]["d"] = rng.standard_normal(
        inp["mamba"]["d"].shape).astype(np.float32)
    inp["mamba_x"] = rng.standard_normal(
        (BLOCK_B, BLOCK_S, mcfg.d_model)).astype(np.float32)
    inp["mamba_ct"] = rng.standard_normal(
        (BLOCK_B, BLOCK_S, mcfg.d_model)).astype(np.float32)
    started = start_meshes(_worker, tmp_path_factory.mktemp("families"),
                           inp)

    ref: dict = {}
    est = jest.make_estimator("full")
    for name in FAMILIES:
        cfg = _cfg(name)
        jcfg = jget_config(name).reduced(
            estimator="full", **({"vocab_size": WHISPER_VOCAB}
                                 if name == "whisper-large-v3" else {}))
        batch_j = {k: jnp.asarray(v if v.dtype == np.float32
                                  else v.astype(np.int32))
                   for k, v in inp["batch"][name].items()}

        def jloss(params, jcfg=jcfg, batch_j=batch_j):
            hh, lab, _ = japi.backbone_hidden(params, batch_j, jcfg,
                                              local_ctx())
            losses = jest.loss_from_embeddings(
                est, japi.head_table(params, jcfg), hh, lab, None, None,
                abs_mode=jcfg.abs_softmax)
            return jnp.mean(losses), hh

        fn = jax.jit(jax.value_and_grad(jloss, has_aux=True))
        for var in variants[name]:
            tree = inp["trees"][name, var]
            (loss, hh), grads = fn(jax.tree_util.tree_map(jnp.asarray, tree))
            gmod = _module(cfg, jax.tree_util.tree_map(np.asarray, grads))
            ref[name, var] = {"loss": float(loss),
                              "h": np.asarray(hh).reshape(B, S, -1),
                              "grads": _numpy(dict(
                                  gmod.named_parameters()))}
            for opt_name in STEP_OPTS:
                opt = _optimizer(opt_name)
                model = _module(cfg, tree)
                state = step.TrainState(model,
                                        opt.init(step.param_dict(model)),
                                        step.empty_state(), 0)
                _, metrics = step.make_train_step(cfg, None, opt)(
                    state, {k: torch.from_numpy(v.copy())
                            for k, v in inp["batch"][name].items()},
                    torch.Generator().manual_seed(1))
                ref[name, var, opt_name] = {
                    "loss": float(metrics["loss"]),
                    "params": _numpy(step.param_dict(model))}
    jmcfg = jget_config("falcon-mamba-7b").reduced()

    def jblock(p, x):
        y = jmamba.apply_mamba(p, x, jmcfg, local_ctx())
        return jnp.sum(y * jnp.asarray(inp["mamba_ct"])), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        jblock, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, inp["mamba"]),
        jnp.asarray(inp["mamba_x"]))
    ref["mamba block"] = {"y": np.asarray(y), "x_grad": np.asarray(gx),
                          "grads": jax.tree_util.tree_map(np.asarray, gp)}
    return inp, ref, {mesh: r.result() for mesh, r in started.items()}


def _ranks(runs, mesh):
    return runs[2][mesh]


# --- the families ---------------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_hidden_loss_and_gradient_shards(runs, mesh, mode, name):
    """Each rank's h rows, the loss and every gradient shard equal the
    reference's single-host results on the same tree, fp32 within 1e-5
    of each whole tensor's max."""
    _, ref, _ = runs
    want = ref[name, _variant(name, mesh, mode)]
    per = B // (mesh[0] * (mesh[1] if mode == "pure_fsdp" else 1))
    for r, res in enumerate(_ranks(runs, mesh)):
        got = res[mode, name]
        i = got["block"]
        close(got["h"], want["h"][i * per:(i + 1) * per],
              what=f"rank {r} h")
        close(got["loss"], want["loss"], what=f"rank {r} loss")
        assert set(got["grads"]) == set(want["grads"])
        for k, g in got["grads"].items():
            whole = want["grads"][k]
            block = _block(whole, got["specs"][k], mesh, r)
            assert g.shape == block.shape, (k, got["specs"][k])
            assert np.abs(g - block).max() <= 1e-5 * np.abs(whole).max(), (
                r, k)


@pytest.mark.parametrize("opt", tuple(STEP_OPTS))
@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_optimizer_step_on_shards(runs, mesh, mode, name, opt):
    """One clip + AdamW or clip + Adafactor step at the full softmax's
    fixed negatives: every updated shard equals its slice of the port's
    unsharded update, fp32 within 1e-5 of the parameter's max."""
    _, ref, _ = runs
    want = ref[name, _variant(name, mesh, mode), opt]
    for r, res in enumerate(_ranks(runs, mesh)):
        got = res[mode, name, opt]
        specs = res[mode, name]["specs"]
        close(got["loss"], want["loss"], what=f"rank {r} loss")
        for k, p in got["params"].items():
            whole = want["params"][k]
            block = _block(whole, specs[k], mesh, r)
            assert p.shape == block.shape
            assert np.abs(p - block).max() <= 1e-5 * np.abs(whole).max(), (
                r, k)


@pytest.mark.parametrize("opt", tuple(STEP_OPTS))
@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_convert_round_trip_is_bitwise(runs, mesh, mode, name, opt):
    """The reference's params and optimizer state go onto each rank's
    shards (a table padded to tp rows first where the mesh pads it) and
    gather back to the same bits."""
    import jax

    inp, _, _ = runs
    var = _variant(name, mesh, mode)
    tree = inp["convert trees"][name, var]
    cfg = _cfg(name, vocab_size=WHISPER_VOCAB)
    whole = dict(_module(cfg, tree).named_parameters())
    n = {"data": mesh[0], "model": mesh[1]}
    for r, res in enumerate(_ranks(runs, mesh)):
        got = res[mode, name, "convert", opt]
        for k, shape in got["shapes"].items():
            want = list(whole[k].shape)
            if k in ("embed_table", "head_w"):  # padded to tp rows
                want[0] = -(-want[0] // mesh[1]) * mesh[1]
            for d, entry in enumerate(got["specs"][k]):
                for a in ((entry,) if isinstance(entry, str)
                          else entry or ()):
                    want[d] //= n[a]
            assert shape == tuple(want), (k, got["specs"][k])
        for got_t, want_t in ((got["back"][0],
                               inp["convert trees"][name, var]),
                              (got["back"][1],
                               inp["opt states"][name, var, opt])):
            g = jax.tree_util.tree_leaves(got_t)
            w = jax.tree_util.tree_leaves(want_t)
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_fit_on_the_mesh(runs, mesh, mode, name):
    """``fit`` with the sampled loss trains each family in
    ``cfg.train_sharding``: finite losses alike on every rank, each rank's
    parameters and AdamW moments the shards ``abstract_train_state``
    gives it in that mode."""
    ranks = _ranks(runs, mesh)
    losses0 = ranks[0][mode, name, "fit"][0]
    assert len(losses0) == FIT_STEPS and np.isfinite(losses0).all()
    for r, res in enumerate(ranks):
        losses, concrete, abstract = res[mode, name, "fit"]
        assert losses == losses0, (r, losses, losses0)
        assert concrete == abstract


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_layouts_by_the_reference_specs(runs, mesh):
    """falcon's in_proj, x_proj and out_proj are stored by the reference's
    specs and the scan runs on d_inner / tp channels under tp_fsdp;
    whisper's vocab is padded to a multiple of tp (512 at tp 4) and its
    cross attention and position tables stay whole; ptb-lstm's tables
    are vocab rows over model and its cells whole."""
    dp, tp = mesh
    falcon, lstm = _cfg("falcon-mamba-7b"), _cfg("ptb-lstm")
    for res in _ranks(runs, mesh):
        specs = res["tp_fsdp", "falcon-mamba-7b"]["specs"]
        assert specs["segments.0.0.mamba.in_proj"] == ("data", "model")
        assert specs["segments.0.0.mamba.x_proj"] == ("model", None)
        assert specs["segments.0.0.mamba.out_proj"] == ("model", "data")
        grads = res["tp_fsdp", "falcon-mamba-7b"]["grads"]
        assert grads["segments.0.0.mamba.a_log"].shape[0] == \
            falcon.d_inner // tp
        w = res["tp_fsdp", "whisper-large-v3"]
        assert w["grads"]["head.w"].shape == (
            -(-WHISPER_VOCAB // tp), 64 // dp)
        assert w["specs"]["dec_blocks.0.xattn.wq"] == (None, None)
        assert w["specs"]["enc_pos.table"] == (None, None)
        lspecs = res["tp_fsdp", "ptb-lstm"]["specs"]
        assert lspecs["embed_table"] == ("model", "data")
        assert lspecs["lstm0_kernel"] == (None, None)
        assert res["tp_fsdp", "ptb-lstm"]["grads"]["embed_table"].shape == (
            lstm.vocab_size // tp, lstm.lstm_units // dp)


# --- the mamba block alone -------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_mamba_block_channel_parallel(runs, mesh):
    """The block over the model group: its output rows, dL/dx and every
    leaf's gradient shard against the reference's ``apply_mamba`` within
    1e-5 of each whole tensor's max; with the backward all-reduce of
    ``x_proj``'s sum taken out the gradients of ``in_proj``, ``conv_w``
    and ``x_proj`` miss by far more (the forward still agrees)."""
    _, ref, _ = runs
    want = ref["mamba block"]
    per = BLOCK_B // mesh[0]
    miss: dict[str, float] = {}
    for r, res in enumerate(_ranks(runs, mesh)):
        got = res["mamba block", False]
        i = got["block"]
        rows = slice(i * per, (i + 1) * per)
        close(got["y"], want["y"][rows], what=f"rank {r} y")
        close(got["x_grad"], want["x_grad"][rows], what=f"rank {r} dL/dx")
        for k, g in got["grads"].items():
            whole = want["grads"][k]
            block = _block(whole, got["specs"][k], mesh, r)
            assert g.shape == block.shape, (k, got["specs"][k])
            assert np.abs(g - block).max() <= 1e-5 * np.abs(whole).max(), (
                r, k)
        bad = res["mamba block", True]
        close(bad["y"], want["y"][rows], what=f"rank {r} y, mutated")
        for k in ("in_proj", "conv_w", "x_proj"):
            whole = want["grads"][k]
            block = _block(whole, bad["specs"][k], mesh, r)
            miss[k] = max(miss.get(k, 0.0), float(
                np.abs(bad["grads"][k] - block).max() / np.abs(whole).max()))
            # every rank's channels miss; in_proj's stored block holds x_in
            # columns on the first half of the model group only (z's
            # gradient does not pass the sum)
            if k != "in_proj":
                assert miss[k] > 1e-3, (r, k, miss[k])
    assert miss["in_proj"] > 1e-3, miss


# --- what stays refused ----------------------------------------------------


class _SizesOnly:
    """What ``rules.ShardCtx`` reads of a mesh before any collective: its
    dims' names and sizes."""

    mesh_dim_names = ("data", "model")

    def __init__(self, dp: int, tp: int):
        self._sizes = (dp, tp)

    def size(self, dim: int) -> int:
        return self._sizes[dim]

    def get_local_rank(self, axis: str) -> int:
        return 0


def _refusals() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import api, transformer
    from repro_torch.optim import make_optimizer
    from repro_torch.serve import engine
    from repro_torch.sharding import rules
    from repro_torch.train import step

    ctx = rules.ShardCtx(mesh=_SizesOnly(1, 4))
    opt = make_optimizer("adamw", 1e-2)
    falcon = get_config("falcon-mamba-7b").reduced()
    jamba = get_config("jamba-v0.1-52b").reduced()
    whisper = _cfg("whisper-large-v3")
    dense = get_config("llama3-8b").reduced()
    return {
        "MLA": lambda: api.require_mesh_layout(dataclasses.replace(
            dense, mla=True)),
        "mtp": lambda: step._on_mesh(dataclasses.replace(
            dense, mtp=True), ctx),
        "hybrid": lambda: api.require_mesh_layout(
            get_config("jamba-v0.1-52b").reduced()),
        "experts": lambda: step._on_mesh(
            get_config("dbrx-132b").reduced(), ctx),
        "encdec init_dec_cache": lambda: _dec_cache_blocks(whisper, ctx),
        "encdec decode_step": lambda: callable(engine.make_decode_step(
            whisper, ctx, 8, frames=4)),
        "ssm init_cache": lambda: _channel_blocks(
            transformer.init_cache(falcon, 2, 8, ctx, device="cpu"), falcon),
        "ssm prefill": lambda: api.require_serve_mesh(falcon),
        "ssm decode_step": lambda: api.require_serve_mesh(falcon),
        "hybrid init_cache": lambda: _hybrid_blocks(
            transformer.init_cache(jamba, 2, 8, ctx, device="cpu"), jamba),
        "hybrid prefill": lambda: api.require_serve_mesh(jamba),
        "moe decode_step": lambda: api.require_serve_mesh(
            get_config("dbrx-132b").reduced()),
        "shard checkpoints": lambda: step.serving_index_source(
            "unused", dense, ctx, opt, device="cpu"),
        "3-D mesh": lambda: rules.mesh_ctx(_ThreeAxes(1, 4)),
    }


class _ThreeAxes(_SizesOnly):
    """A mesh of the reference's 3-D host layout, by its dims' names."""

    mesh_dim_names = ("replica", "data", "model")


def _channel_blocks(caches, cfg) -> bool:
    """Whether a (1, 4) rank's mamba caches hold its quarter of the
    channels."""
    c = caches[0]
    return c["conv"].shape[-1] == c["ssm"].shape[-2] == cfg.d_inner // 4


def _hybrid_blocks(caches, cfg) -> bool:
    """Whether a (1, 4) rank's hybrid caches hold its blocks: a quarter
    of the attention's sequence, a quarter of the mamba channels."""
    for (kind, _), c in zip(_segments(cfg), caches):
        if kind.startswith("attn"):
            assert c["k"].shape[2] == 2, c["k"].shape
        else:
            assert c["conv"].shape[-1] == cfg.d_inner // 4
    return True


def _segments(cfg):
    from repro_torch.models import transformer

    return transformer.segments_of(cfg)


def _dec_cache_blocks(cfg, ctx) -> bool:
    """Whether a (1, 4) rank's encoder-decoder cache holds its blocks
    (``encdec.cache_specs``): a quarter of the self and cross sequences."""
    from repro_torch.models import encdec
    from repro_torch.sharding import rules

    specs = encdec.cache_specs(cfg, 2, 8, 4, ctx)
    whole = encdec._cache_shapes(cfg, 2, 8, 4, ctx.tp_backbone)
    held = {k: rules.local_shape(sh, specs[k], ctx)
            for k, sh in whole.items()}
    return held["self_k"][2] == 2 and held["cross_k"][2] == 1


#: refusals that expert parallelism lifted (these cases pass the gates),
#: and the ssm, hybrid, moe and encoder-decoder families' serving on the
#: mesh (their caches hold a rank's blocks; they pass the serving gate;
#: their prefill and decode are held in test_torch_mesh_lm_serving.py and
#: test_torch_mesh_family_serving.py)
PORTED_SINCE = ("MLA", "mtp", "hybrid", "experts", "ssm init_cache",
                "ssm prefill", "ssm decode_step", "encdec init_dec_cache",
                "encdec decode_step", "hybrid init_cache", "hybrid prefill",
                "moe decode_step")


@pytest.mark.parametrize("case", tuple(_refusals()))
def test_refusals_name_a17(case):
    """What stays refused on a mesh raises ``NotImplementedError`` naming
    A17, before any collective; MLA, mtp, the hybrid family and experts
    pass the mesh's gates since expert parallelism was ported, the ssm
    family's serving since the decoder LMs' serving engine was, and the
    hybrid, moe and encoder-decoder families' serving (caches, prefill,
    decode) since the rest of serving was."""
    if case in PORTED_SINCE:
        assert _refusals()[case]() in (None, True)
        return
    with pytest.raises(NotImplementedError, match="A17"):
        _refusals()[case]()


def test_the_three_families_pass_the_gate():
    """The ssm, encdec and lstm families pass the mesh's family gate, and
    so do the moe and hybrid ones."""
    from repro_torch.configs import get_config
    from repro_torch.models import api

    for name in FAMILIES + ("jamba-v0.1-52b", "dbrx-132b",
                            "deepseek-v3-671b"):
        api.require_mesh_layout(get_config(name))
