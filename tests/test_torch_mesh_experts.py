"""Expert parallelism and the sequence-sharded residual stream on a
(data, model) mesh (``models/moe.py``, ``models/layers.py``,
``models/mla.py``, ``models/mamba.py``, ``models/transformer.py``,
``models/api.py``, ``sharding/rules.py``, ``core/distributed.py``,
``train/step.py``, ``optim/``, ``convert.py``) against the reference's
own mesh path.

The reference runs in one subprocess of 8 host devices on
``jax.sharding.Mesh`` meshes built from the device list (their axes are
Auto, so its ``ShardCtx.act`` constraints and its MoE ``shard_map`` run):
``jax.jit(jax.value_and_grad)`` of the full-softmax loss (the fixed
negatives: every class) plus 0.01 x aux over ``api.backbone_hidden``
with ``rules.ctx_for_train``'s ctx, its parameters placed by
``param_specs_for``.  The port runs on gloo ranks
(``torch_mesh_util``) in tp_fsdp with ``seq_residuals`` as each config
sets it, through ``train.step.make_train_step``.  Each config is
``.reduced(seq_sharded_residuals=True)`` in fp32:

  * dbrx-132b (2 layers) at (1, 4) and (2, 2), S 8: the residual stream
    S-sharded everywhere;
  * deepseek-v3-671b (a dense MLA layer, an MLA + MoE layer with the
    sigmoid router, ``router_bias`` and the shared expert, the mtp block)
    at (1, 4), S 9: tp does not divide S, so the backbone's stream stays
    replicated (``rules.seq_sharded``, the reference's ``fit_spec``), and
    divides the mtp block's S - 1 = 8, whose stream is S-sharded;
  * jamba-v0.1-52b (3 layers, its attention moved to offset 2: mamba+mlp,
    mamba+moe, attn+mlp) at (2, 2), S 8;
  * chameleon-34b (2 layers, qk-norm, no ``seq_residuals``) at (1, 4):
    its per-head q/k norm scales' gradients are parts on each model rank
    and are summed over ``model`` (``rules.model_partial``).

Held: h (and the mtp rows), aux, the loss and every leaf's gradient shard
within 1e-5 of each whole tensor's max; dbrx's h at (2, 2) with
``seq_residuals`` off; the MoE layer alone at a capacity factor of 0.5
(its output, aux, and per data shard the drops summed over the model
ranks equal the reference's and the mesh-free layer's on that shard's
rows); one clip + Adafactor step of dbrx at (2, 2) (no drops) against
the port's unsharded update; ``convert``'s train state onto the shards
and back, bitwise; 2 ``fit`` steps of each config on its mesh; experts in
pure_fsdp raise.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from test_torch_mesh_families import (
    _block,
    _capture,
    _module,
    _numpy,
    _optimizer,
)
from torch_mesh_util import Reference, close, mesh_id, start_meshes

torch.set_num_threads(1)

B = 4
#: (config, mesh, S)
CASES = (("dbrx-132b", (1, 4), 8), ("dbrx-132b", (2, 2), 8),
         ("deepseek-v3-671b", (1, 4), 9), ("jamba-v0.1-52b", (2, 2), 8),
         ("chameleon-34b", (1, 4), 8))
MESHES = ((1, 4), (2, 2))
#: each config's changes to ``.reduced()`` (beside ``estimator="full"``)
OVERRIDES = {
    "dbrx-132b": dict(n_layers=2, seq_sharded_residuals=True),
    "deepseek-v3-671b": dict(n_layers=2, seq_sharded_residuals=True),
    "jamba-v0.1-52b": dict(n_layers=3, attn_layer_offset=2,
                           seq_sharded_residuals=True),
    "chameleon-34b": dict(n_layers=2)}
#: the MoE layer alone: its capacity factor (assignments drop)
MOE_FACTOR = 0.5
#: the Adafactor step's config and mesh: no drops, so the unsharded step
#: routes and keeps the same assignments
STEP_CASE = ("dbrx-132b", (2, 2), 8)
FIT_STEPS = 2


def case_id(case) -> str:
    name, mesh, s = case
    return f"{name}-{mesh_id(mesh)}-s{s}"


def _cfg(name: str, **changes):
    from repro_torch.configs import get_config

    return get_config(name).reduced(
        **{"estimator": "full", **OVERRIDES[name], **changes})


def _key(case) -> str:
    """A case's key in the reference's npz: its config, mesh and S."""
    name, (dp, tp), s = case
    return f"{name}:{dp}:{tp}:{s}"


def _flat(tree, prefix: str, out: dict) -> dict:
    """A nested dict / list of arrays as {prefix/path: array}."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _unflat(flat: dict, prefix: str):
    """``_flat``'s inverse for the keys under ``prefix/``."""
    root: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *parts, last = key[len(prefix) + 1:].split("/")
        d = root
        for p in parts:
            d = d.setdefault(p, {})
        d[last] = v

    def fix(d):
        if not isinstance(d, dict):
            return d
        if d and all(k.isdigit() for k in d):
            return [fix(d[str(i)]) for i in range(len(d))]
        return {k: fix(v) for k, v in d.items()}

    return fix(root)


REF_SCRIPT = r'''
import json
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.configs import get_config
from repro.core import estimators as E
from repro.models import api, moe, transformer
from repro.sharding import rules


def unflat(flat, prefix):
    root = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *parts, last = key[len(prefix) + 1:].split("/")
        d = root
        for p in parts:
            d = d.setdefault(p, {})
        d[last] = jnp.asarray(v)

    def fix(d):
        if not isinstance(d, dict):
            return d
        if d and all(k.isdigit() for k in d):
            return [fix(d[str(i)]) for i in range(len(d))]
        return {k: fix(v) for k, v in d.items()}

    return fix(root)


def flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = np.asarray(tree)


def mesh_of(dp, tp):
    return Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))


inp = dict(np.load(sys.argv[1]))
overrides = json.loads(str(inp["overrides"]))
out = {}
est = E.make_estimator("full")
for key in [str(k) for k in inp["cases"]]:
    name, dp, tp, s = key.split(":")
    dp, tp, s = int(dp), int(tp), int(s)
    cfg = get_config(name).reduced(estimator="full", **overrides[name])
    mesh = mesh_of(dp, tp)
    ctx = rules.ctx_for_train(mesh, cfg)
    params = unflat(inp, key)
    specs = rules.param_specs_for(params, ctx)
    params = jax.tree_util.tree_map(
        lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)),
        params, specs)
    batch = {"tokens": jnp.asarray(inp[key + "|tokens"]),
             "labels": jnp.asarray(inp[key + "|labels"])}

    def total(p, cfg=cfg, ctx=ctx, batch=batch):
        h, lab, aux = api.backbone_hidden(p, batch, cfg, ctx)
        loss = jnp.mean(E.loss_from_embeddings(
            est, api.head_table(p, cfg), h, lab, None, None,
            abs_mode=cfg.abs_softmax))
        return loss + 0.01 * aux, (loss, aux, h)

    (_, (loss, aux, h)), g = jax.jit(jax.value_and_grad(
        total, has_aux=True))(params)
    out[key + "|loss"] = np.asarray(loss)
    out[key + "|aux"] = np.asarray(aux)
    out[key + "|h"] = np.asarray(h)
    flat(jax.tree_util.tree_map(np.asarray, g), key + "|grad", out)
    if key.startswith("dbrx-132b:2:2"):
        cfg_off = get_config(name).reduced(
            **{**overrides[name], "seq_sharded_residuals": False})
        ctx_off = rules.ctx_for_train(mesh, cfg_off)
        out[key + "|h off"] = np.asarray(jax.jit(
            lambda p: transformer.hidden_states(
                p, batch["tokens"], cfg_off, ctx_off)[0])(params))

# the MoE layer alone, with drops
cfg = get_config("dbrx-132b").reduced(
    seq_sharded_residuals=True, capacity_factor=float(inp["moe_factor"]))
p = unflat(inp, "moe")
x = jnp.asarray(inp["moe_x"])
k, e = cfg.moe_top_k, cfg.n_experts


@jax.jit
def alone(p, xi):
    """The mesh-free layer on a data shard's rows, and its drops."""
    x2d = xi.reshape(-1, xi.shape[-1])
    t = x2d.shape[0]
    ids = moe._route(p, x2d, cfg)[0].reshape(-1)
    cap = int(max(k, np.ceil(t * k / e * cfg.capacity_factor)))
    onehot = jax.nn.one_hot(ids, e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    return (moe.apply_moe(p, xi, cfg, rules.local_ctx())[0],
            jnp.sum(pos >= cap))


for dp, tp in [tuple(m) for m in inp["meshes"]]:
    ctx = rules.mesh_ctx(mesh_of(dp, tp), "tp_fsdp", seq_residuals=True)
    y, aux = jax.jit(lambda p, x: moe.apply_moe(p, x, cfg, ctx))(p, x)
    key = f"moe:{dp}:{tp}"
    out[key + "|y"], out[key + "|aux"] = np.asarray(y), np.asarray(aux)
    per = x.shape[0] // dp
    got = [alone(p, x[i * per:(i + 1) * per]) for i in range(dp)]
    out[key + "|drops"] = np.asarray([int(d) for _, d in got])
    out[key + "|alone"] = np.concatenate([np.asarray(a) for a, _ in got])
np.savez(sys.argv[2], **out)
'''


def _tree(name: str, tp: int) -> dict:
    """The reference-form tree (numpy) of a config's reduced variant,
    its heads padded for a backbone of tp ``tp``."""
    from repro_torch import convert
    from repro_torch.models import transformer

    gen = torch.Generator().manual_seed(33)
    tree = transformer.init_lm(gen, _cfg(name), "cpu", tp=tp)
    for seg in tree["segments"]:  # routers off uniform, biases nonzero
        if "moe" in seg and "router_bias" in seg["moe"]:
            seg["moe"]["router_bias"].normal_(generator=gen).mul_(0.01)
    return convert.params_to_jax(tree)


def _inputs() -> dict:
    rng = np.random.default_rng(33)
    inp = {"trees": {}, "batch": {}}
    for name, (dp, tp), s in CASES:
        if (name, tp) not in inp["trees"]:
            inp["trees"][name, tp] = _tree(name, tp)
        vocab = _cfg(name).vocab_size
        inp["batch"][name, s] = {
            "tokens": rng.integers(0, vocab, (B, s)),
            "labels": rng.integers(0, vocab, (B, s))}
    moe_tree = inp["trees"]["dbrx-132b", 4]["segments"][0]["moe"]
    inp["moe"] = {k: v[0] for k, v in moe_tree.items()}
    inp["moe_x"] = rng.standard_normal(
        (B, 8, _cfg("dbrx-132b").d_model)).astype(np.float32)
    return inp


def _ref_inputs(inp: dict) -> dict:
    flat: dict = {"cases": np.asarray([_key(c) for c in CASES]),
                  "overrides": np.asarray(json.dumps(OVERRIDES)),
                  "meshes": np.asarray(MESHES),
                  "moe_factor": np.asarray(MOE_FACTOR),
                  "moe_x": inp["moe_x"]}
    for case in CASES:
        name, (_, tp), s = case
        key = _key(case)
        _flat(inp["trees"][name, tp], key, flat)
        for k, v in inp["batch"][name, s].items():
            flat[f"{key}|{k}"] = v.astype(np.int32)
    _flat(inp["moe"], "moe", flat)
    return flat


# --- ranks ------------------------------------------------------------------


def _rows(x: torch.Tensor, b: int, s: int) -> tuple[np.ndarray, ...]:
    """The backbone's (b, s, d) rows of a flattened h, and the mtp block's
    (b, s - 2, d) rows after them where it has any."""
    x = x.detach().numpy()
    d = x.shape[-1]
    main = x[:b * s].reshape(b, s, d)
    if x.shape[0] == b * s:
        return (main,)
    return main, x[b * s:].reshape(b, s - 2, d)


def _case_run(ctx, inp: dict, case) -> dict:
    """One config's train step on this rank (a capturing optimizer): h,
    loss, aux and every gradient shard as the step reduces them."""
    from repro_torch.models import api
    from repro_torch.sharding import rules
    from repro_torch.train import step

    name, (_, tp), s = case
    cfg = _cfg(name)
    mctx = rules.ctx_for_train(ctx.mesh, cfg)
    batch = {k: rules.batch_rows(torch.from_numpy(v.copy()), mctx)
             for k, v in inp["batch"][name, s].items()}
    model = step.shard_params(_module(cfg, inp["trees"][name, tp]), cfg,
                              mctx)
    opt, got = _capture()
    _, metrics = step.make_train_step(cfg, mctx, opt)(
        step.TrainState(model, (), step.empty_state(), 0), batch,
        torch.Generator().manual_seed(1))
    with torch.no_grad():
        h, _, _ = api.backbone_hidden(model, batch, cfg, mctx)
    out = {"h": _rows(h, B // mctx.dp, s), "loss": float(metrics["loss"]),
           "aux": float(metrics["aux_loss"]), "grads": _numpy(got),
           "specs": dict(model.param_specs), "block": mctx.batch_index}
    if case == ("dbrx-132b", (2, 2), 8):
        ocfg = _cfg(name, seq_sharded_residuals=False)
        octx = rules.ctx_for_train(ctx.mesh, ocfg)
        with torch.no_grad():
            h, _, _ = api.backbone_hidden(model, batch, ocfg, octx)
        out["h off"] = _rows(h, B // mctx.dp, s)
    return out


def _moe_alone(ctx, inp: dict) -> dict:
    """The first MoE layer of dbrx alone on this rank's data rows (x and y
    S-sharded), at ``MOE_FACTOR``: y, aux and this rank's experts'
    drops."""
    from repro_torch.models import moe
    from repro_torch.sharding import rules

    cfg = _cfg("dbrx-132b", capacity_factor=MOE_FACTOR)
    mctx = rules.ctx_for_train(ctx.mesh, cfg)
    specs = {k: rules.spec_for(f"segments.0.0.moe.{k}", v.shape, mctx)
             for k, v in inp["moe"].items()}
    p = {k: rules.compute_view(rules.shard_by_spec(
        torch.from_numpy(v), specs[k], mctx), specs[k], mctx)
        for k, v in inp["moe"].items()}
    x = rules.batch_rows(torch.from_numpy(inp["moe_x"]), mctx)
    s = x.shape[1]
    seq = rules.seq_sharded(mctx, s)
    x_in = rules.shard_by_spec(x, (None, mctx.model_axis), mctx) if seq \
        else x
    y, aux = moe.apply_moe(p, x_in, cfg, mctx, seq)
    x2d = x.reshape(-1, x.shape[-1])
    e_l = cfg.n_experts // mctx.tp
    drops = moe.dropped(moe._route(p, x2d, cfg)[0], cfg,
                        moe.capacity(x2d.shape[0], cfg),
                        mctx.model_index * e_l, e_l)
    return {"y": y.detach().numpy(), "aux": float(aux), "drops": drops,
            "seq": seq, "block": mctx.batch_index,
            "model": mctx.model_index}


def _adafactor_step(ctx, inp: dict) -> dict:
    """One clip + Adafactor step of ``STEP_CASE`` at capacity 8 (nothing
    drops): the updated shards."""
    from repro_torch.sharding import rules
    from repro_torch.train import step

    name, (_, tp), s = STEP_CASE
    cfg = _cfg(name, capacity_factor=8.0)
    mctx = rules.ctx_for_train(ctx.mesh, cfg)
    batch = {k: rules.batch_rows(torch.from_numpy(v.copy()), mctx)
             for k, v in inp["batch"][name, s].items()}
    opt = _optimizer("adafactor")
    model = step.shard_params(_module(cfg, inp["trees"][name, tp]), cfg,
                              mctx)
    state = step.TrainState(model, opt.init(step.param_dict(model)),
                            step.empty_state(), 0)
    _, metrics = step.make_train_step(cfg, mctx, opt)(
        state, batch, torch.Generator().manual_seed(1))
    return {"loss": float(metrics["loss"]),
            "params": _numpy(step.param_dict(model)),
            "specs": dict(model.param_specs)}


def _convert_and_fit(ctx, inp: dict, case) -> dict:
    """The config's Adafactor train state onto this rank's shards and back,
    and 2 ``fit`` steps with its own sampler (block-quadratic-shared)."""
    from repro_torch import convert
    from repro_torch.data.pipeline import batch_iterator_for
    from repro_torch.optim import make_optimizer
    from repro_torch.sharding import rules
    from repro_torch.train import loop, step

    name, (_, tp), s = case
    cfg = _cfg(name)
    mctx = rules.ctx_for_train(ctx.mesh, cfg)
    tree = inp["trees"][name, tp]
    opt = make_optimizer("adafactor", 1e-2)
    model = _module(cfg, tree)
    gen = torch.Generator().manual_seed(3)
    ostate = convert._map_tree(lambda t: torch.rand(
        t.shape, generator=gen) if t.dim() else t,
        opt.init(step.param_dict(model)))
    whole = convert.train_state_to_jax(step.TrainState(
        model, ostate, step.empty_state(), 0))
    shard = convert.train_state_from_jax(
        whole[0], whole[1], {"stats": {}, "const": {}}, 3, cfg,
        device="cpu", ctx=mctx)
    back = convert.train_state_to_jax(shard, cfg, mctx)
    fcfg = _cfg(name, estimator="sampled-softmax", remat=True)
    res = loop.fit(fcfg, ctx, opt, batch_iterator_for(
        fcfg, ctx, B, s, device="cpu"), FIT_STEPS, log_every=0,
        device="cpu")
    shapes = {k: tuple(p.shape)
              for k, p in res.state.params.named_parameters()}
    abstract = {k: tuple(p.shape) for k, p in step.abstract_train_state(
        fcfg, mctx, opt).params.named_parameters()}
    return {"whole": whole[:2], "back": back[:2], "losses": res.losses,
            "shapes": shapes, "abstract": shapes == abstract}


def _worker(ctx, inp: dict) -> dict:
    from repro_torch.optim import make_optimizer
    from repro_torch.sharding import rules
    from repro_torch.train import step

    mesh = (ctx.axis_size("data"), ctx.tp)
    out: dict = {}
    for case in CASES:
        if case[1] == mesh:
            out[case] = _case_run(ctx, inp, case)
            if case[0] != "chameleon-34b":
                out[case, "convert fit"] = _convert_and_fit(ctx, inp, case)
    out["moe"] = _moe_alone(ctx, inp)
    if STEP_CASE[1] == mesh:
        out["adafactor"] = _adafactor_step(ctx, inp)
    try:
        step.make_train_step(_cfg("dbrx-132b"), rules.mesh_ctx(
            ctx.mesh, "pure_fsdp"), make_optimizer("adamw", 1e-2))
        out["pure_fsdp"] = None
    except ValueError as e:
        out["pure_fsdp"] = str(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's mesh results and every mesh's ranks' from the same
    inputs, and the port's unsharded Adafactor step."""
    import jax

    from repro_torch.train import step

    base = tmp_path_factory.mktemp("mesh_experts")
    inp = _inputs()
    ref = Reference(REF_SCRIPT, _ref_inputs(inp), base)
    started = start_meshes(_worker, base, inp, meshes=MESHES)
    name, (_, tp), s = STEP_CASE
    cfg = _cfg(name, capacity_factor=8.0)
    opt = _optimizer("adafactor")
    model = _module(cfg, inp["trees"][name, tp])
    state = step.TrainState(model, opt.init(step.param_dict(model)),
                            step.empty_state(), 0)
    _, metrics = step.make_train_step(cfg, None, opt)(
        state, {k: torch.from_numpy(v.copy())
                for k, v in inp["batch"][name, s].items()},
        torch.Generator().manual_seed(1))
    unsharded = {"loss": float(metrics["loss"]),
                 "params": _numpy(step.param_dict(model))}
    got = ref.result()
    refs = {}
    for case in CASES:
        key = _key(case)
        grads = jax.tree_util.tree_map(
            np.asarray, _unflat(got, key + "|grad"))
        name = case[0]
        refs[case] = {
            "loss": float(got[key + "|loss"]),
            "aux": float(got[key + "|aux"]),
            "h": got[key + "|h"],
            "h off": got.get(key + "|h off"),
            "grads": _numpy(dict(_module(_cfg(name), grads)
                                 .named_parameters()))}
    for dp, tp in MESHES:
        key = f"moe:{dp}:{tp}"
        refs["moe", (dp, tp)] = {k: got[f"{key}|{k}"]
                                 for k in ("y", "aux", "drops", "alone")}
    ranks = {mesh: r.result() for mesh, r in started.items()}
    return inp, refs, ranks, unsharded


def _ref_rows(h: np.ndarray, s: int, mtp: bool) -> tuple[np.ndarray, ...]:
    """The reference's flattened h as ``_rows`` splits the port's."""
    return _rows(torch.from_numpy(h), B, s) if mtp else (
        h[:B * s].reshape(B, s, -1),)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_hidden_states_aux_and_loss(runs, case):
    """Each rank's h rows (the mtp block's too), aux and the loss equal
    the reference's mesh results, fp32 within 1e-5 of each tensor's
    max."""
    _, refs, ranks, _ = runs
    name, mesh, s = case
    want = refs[case]
    wants = _ref_rows(want["h"], s, _cfg(name).mtp)
    per = B // mesh[0]
    for r, res in enumerate(ranks[mesh]):
        got = res[case]
        i = got["block"]
        assert len(got["h"]) == len(wants)
        for part, (g, w) in enumerate(zip(got["h"], wants)):
            close(g, w[i * per:(i + 1) * per], what=f"rank {r} h {part}")
        close(got["loss"], want["loss"], what=f"rank {r} loss")
        close(got["aux"], want["aux"], what=f"rank {r} aux")


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_every_gradient_shard(runs, case):
    """Every leaf's gradient shard as the train step reduces it (experts
    over ``data`` by their gather's backward, the router over both axes,
    the replicated leaves on S-shards over ``model``) equals its block of
    the reference's mesh gradient within 1e-5 of the leaf's max."""
    _, refs, ranks, _ = runs
    name, mesh, _ = case
    want = refs[case]["grads"]
    for r, res in enumerate(ranks[mesh]):
        got = res[case]
        assert set(got["grads"]) == set(want)
        for k, g in got["grads"].items():
            whole = want[k]
            block = _block(whole, got["specs"][k], mesh, r)
            assert g.shape == block.shape, (k, got["specs"][k])
            assert np.abs(g - block).max() <= 1e-5 * max(
                np.abs(whole).max(), 1e-30), (r, k)


def test_hidden_states_without_seq_residuals(runs):
    """dbrx's h at (2, 2) with ``seq_residuals`` off (the stream
    replicated over ``model``) equals the reference's, and the S-sharded
    run's."""
    _, refs, ranks, _ = runs
    case = ("dbrx-132b", (2, 2), 8)
    want = refs[case]["h off"].reshape(B, 8, -1)
    for r, res in enumerate(ranks[(2, 2)]):
        got = res[case]
        i = got["block"]
        rows = want[i * 2:(i + 1) * 2]
        close(got["h off"][0], rows, what=f"rank {r} h, seq off")
        close(got["h"][0], rows, what=f"rank {r} h, seq on")


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_moe_layer_drops_per_data_shard(runs, mesh):
    """The MoE layer alone at a capacity factor of 0.5: each rank's
    S-shard of y and aux equal the reference's ``apply_moe`` on the mesh,
    which equals the mesh-free layer on each data shard's rows; the drops
    of a data row's model ranks add up to the reference's count on its
    rows (capacity from the local rows), and some do drop."""
    _, refs, ranks, _ = runs
    want = refs["moe", mesh]
    dp, tp = mesh
    per = B // dp
    close(want["y"], want["alone"], what="reference mesh vs mesh-free")
    drops = np.zeros(dp, dtype=np.int64)
    for r, res in enumerate(ranks[mesh]):
        got = res["moe"]
        i, j = got["block"], got["model"]
        rows = want["y"][i * per:(i + 1) * per]
        assert got["seq"]
        s_l = rows.shape[1] // tp
        close(got["y"], rows[:, j * s_l:(j + 1) * s_l], what=f"rank {r} y")
        close(got["aux"], want["aux"], what=f"rank {r} aux")
        drops[i] += got["drops"]
    np.testing.assert_array_equal(drops, want["drops"])
    assert (drops > 0).all(), drops


def test_adafactor_step_on_expert_shards(runs):
    """One clip + Adafactor step of dbrx at (2, 2): every updated shard
    (the experts' (E / tp, d / dp, f) among them, their factored means
    over the whole leaf) equals its block of the port's unsharded
    update within 1e-5 of the parameter's max."""
    _, _, ranks, unsharded = runs
    mesh = STEP_CASE[1]
    for r, res in enumerate(ranks[mesh]):
        got = res["adafactor"]
        close(got["loss"], unsharded["loss"], what=f"rank {r} loss")
        for k, p in got["params"].items():
            whole = unsharded["params"][k]
            block = _block(whole, got["specs"][k], mesh, r)
            assert p.shape == block.shape
            assert np.abs(p - block).max() <= 1e-5 * np.abs(whole).max(), (
                r, k)
    specs = ranks[mesh][0]["adafactor"]["specs"]
    assert specs["segments.0.0.moe.w_gate"] == ("model", "data", None)
    assert specs["segments.0.0.moe.router"] == (None, None)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[0] != "chameleon-34b"], ids=case_id)
def test_convert_round_trip_and_fit(runs, case):
    """The Adafactor train state (the mtp subtree and ``router_bias``
    included) onto each rank's shards and back is bitwise; 2 ``fit``
    steps give finite losses alike on every rank and the shards
    ``abstract_train_state`` gives."""
    import jax

    ranks = runs[2][case[1]]
    losses0 = ranks[0][case, "convert fit"]["losses"]
    assert len(losses0) == FIT_STEPS and np.isfinite(losses0).all()
    for r, res in enumerate(ranks):
        got = res[case, "convert fit"]
        for a, b in zip(got["back"], got["whole"]):
            ga, gb = (jax.tree_util.tree_leaves(t) for t in (a, b))
            assert len(ga) == len(gb)
            for x, y in zip(ga, gb):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert got["losses"] == losses0, (r, got["losses"], losses0)
        assert got["abstract"]
    if case[0] == "deepseek-v3-671b":
        assert "mtp" in ranks[0][case, "convert fit"]["whole"][0]


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_experts_in_pure_fsdp_raise(runs, mesh):
    """An expert config in pure_fsdp is refused before any collective, as
    the reference asserts (the experts live on ``model``)."""
    for res in runs[2][mesh]:
        assert res["pure_fsdp"] and "tp_fsdp" in res["pure_fsdp"]
