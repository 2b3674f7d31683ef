"""The port's Adafactor (``repro_torch.optim.adafactor``) against the
reference's (``repro.optim.adafactor``) on a stacked tree, on the CPU.

The port updates a ``StackedLM``'s per-layer views, the reference its
stacked leaves.  A tree with every kind of leaf: a (count > 1, a, b)
stack (matrices, factored per layer), a (count > 1, E, a, b) stack (an
expert stack, factored per layer and expert), a (count > 1, d) stack (a
norm scale: factored ACROSS the layers, one column statistic shared), a
(1, d) stack (a one-layer segment's), a 2-D leaf outside the segments, a
1-D leaf (unfactored) and gradients large enough that the update's RMS
exceeds 1 (update clipping, over the whole stack).  Five steps; the
parameters and the statistics after each within 1e-6 (rtol and atol: one
fp32 sum order apart).  A per-view factoring of the (count, d) stack is
shown to differ.  The state crosses ``convert`` both ways and through the
checkpoint manager's keys; ``make_optimizer("adafactor")`` on a
``StackedLM`` holds the reference's shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.optim import adafactor as jadafactor
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim.schedule import cosine_schedule as jcosine
from repro.sharding.rules import local_ctx
from repro_torch import convert
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.optim import adafactor, make_optimizer
from repro_torch.optim.adafactor import stacks
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.optim.transform import apply_updates
from repro_torch.train import step

torch.set_num_threads(1)

CTX = local_ctx()
COUNT = 3
TOL = 1e-6
#: the reference tree: {"segments": [...], "embed": ..., "final_norm": ...}
SHAPES = {"segments": [{"w": (COUNT, 6, 5), "experts": (COUNT, 2, 4, 3),
                        "scale": (COUNT, 7)},
                       {"s": (1, 7)}],
          "embed": {"table": (9, 7)},
          "final_norm": {"scale": (7,)}}

OPTS = {
    "defaults": (lambda: adafactor(1e-2), lambda: jadafactor(1e-2)),
    "decay-and-schedule": (
        lambda: adafactor(cosine_schedule(3e-2, 2, 5), weight_decay=0.1),
        lambda: jadafactor(jcosine(3e-2, 2, 5), weight_decay=0.1)),
}


def _tree(rng, scale=1.0):
    def leaf(shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"segments": [{k: leaf(v) for k, v in seg.items()}
                         for seg in SHAPES["segments"]],
            "embed": {"table": leaf(SHAPES["embed"]["table"])},
            "final_norm": {"scale": leaf(SHAPES["final_norm"]["scale"])}}


def _views(tree: dict) -> dict:
    """The reference tree as the port holds it: torch tensors, a segment's
    leaves as per-layer views ``segments.<s>.<i>.<name>``."""
    out = {"embed.table": torch.from_numpy(tree["embed"]["table"]),
           "final_norm.scale": torch.from_numpy(tree["final_norm"]["scale"])}
    for s, seg in enumerate(tree["segments"]):
        for name, arr in seg.items():
            t = torch.from_numpy(arr)
            for i in range(t.shape[0]):
                out[f"segments.{s}.{i}.{name}"] = t[i]
    return out


def _stacked(views: dict) -> dict:
    """Per-layer tensors stacked back into the reference's tree."""
    out = {"embed": {"table": views["embed.table"].numpy()},
           "final_norm": {"scale": views["final_norm.scale"].numpy()},
           "segments": [{} for _ in SHAPES["segments"]]}
    for key, members in stacks(views).items():
        if key.startswith("segments."):
            _, s, name = key.split(".", 2)
            out["segments"][int(s)][name] = torch.stack(
                [views[m] for m in members]).numpy()
    return out


def _grads(step_i: int):
    # alternating scales: the RMS clip binds on the large steps
    return _tree(np.random.default_rng(100 + step_i),
                 scale=(30.0, 1e-3, 5.0, 0.1, 1.0)[step_i])


def _assert_tree_close(got, want, msg):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w], msg
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"{msg} "
                                   f"{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("name", sorted(OPTS))
def test_per_view_updates_match_the_reference_stack(name):
    mk, jmk = OPTS[name]
    opt, jopt = mk(), jmk()
    start = _tree(np.random.default_rng(0))
    theirs = jax.tree_util.tree_map(jnp.asarray, start)
    mine = _views(jax.tree_util.tree_map(np.copy, start))
    state, jstate = opt.init(mine), jopt.init(theirs)
    jupdate = jax.jit(jopt.update)
    for i in range(5):
        g = _grads(i)
        upd, state = opt.update(_views(g), state, mine)
        assert upd == {}  # applied in place
        apply_updates(mine, upd)
        jupd, jstate = jupdate(jax.tree_util.tree_map(jnp.asarray, g),
                               jstate, theirs)
        theirs = jax.tree_util.tree_map(lambda p, u: p + u, theirs, jupd)
        _assert_tree_close(_stacked(mine), theirs, f"{name} step {i}")
        got_v = {"segments": [{}, {}], "embed": {}, "final_norm": {}}
        for key, v in state["v"].items():
            parts = key.split(".")
            node = got_v["segments"][int(parts[1])] \
                if parts[0] == "segments" else got_v[parts[0]]
            node[parts[-1]] = {k: t.numpy() for k, t in v.items()}
        _assert_tree_close(got_v, jstate["v"], f"{name} stats {i}")
        assert int(state["step"]) == int(jstate["step"]) == i + 1


def test_the_reference_factors_a_norm_stack_across_layers():
    """The (count, d) stack keeps vr (count,) and one vc (d,); factoring
    each layer's (d,) view on its own (the unfactored branch) gives other
    parameters: the trap the stack grouping avoids."""
    opt = adafactor(1e-2)
    start = _tree(np.random.default_rng(0))
    mine = _views(jax.tree_util.tree_map(np.copy, start))
    state = opt.init(mine)
    v = state["v"]["segments.0.scale"]
    assert v["vr"].shape == (COUNT,) and v["vc"].shape == (7,)
    assert state["v"]["segments.0.w"]["vr"].shape == (COUNT, 6)
    assert state["v"]["segments.0.experts"]["vc"].shape == (COUNT, 2, 3)
    assert set(state["v"]["final_norm.scale"]) == {"v"}
    # each view its own leaf: renamed so no stack groups them
    apart = {k.replace(".", "_"): t.clone() for k, t in mine.items()}
    opt.update(_views(_grads(2)), state, mine)
    g = {k.replace(".", "_"): t for k, t in _views(_grads(2)).items()}
    opt.update(g, opt.init(apart), apart)
    for i in range(COUNT):
        key = f"segments.0.{i}.scale"
        assert not torch.allclose(mine[key], apart[key.replace(".", "_")],
                                  rtol=1e-4, atol=0)


def test_make_optimizer_on_a_stacked_lm_holds_the_reference_shapes():
    arch = "falcon-mamba-7b"
    cfg = get_config(arch).reduced()
    jcfg = jget_config(arch).reduced()
    model = api.init_module(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = make_optimizer("adafactor", 1e-3)
    state = opt.init(step.param_dict(model))
    jparams = jax.eval_shape(lambda k: japi.init_params(k, jcfg, CTX),
                             jax.random.PRNGKey(0))
    jstate = jax.eval_shape(jmake_optimizer("adafactor", 1e-3).init,
                            jparams)
    ts = step.TrainState(params=model, opt_state=state,
                         sampler_state=step.empty_state(), step=0)
    got = convert.reference_tree(ts).opt_state
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(jstate)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_g] == \
        [jax.tree_util.keystr(p) for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert tuple(g.shape) == tuple(w.shape), jax.tree_util.keystr(path)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
    # the manager's keys: the reference's paths
    keys = [k for k, _ in manager_mod._leaves(convert.reference_tree(ts))]
    assert ".opt_state/1/v/segments/0/mamba/in_proj/vr" in keys
    assert ".opt_state/1/v/segments/0/norm1/scale/vc" in keys
    assert ".opt_state/1/v/final_norm/scale/v" in keys


@pytest.mark.parametrize("opt_name", ["adafactor", "adamw"])
def test_lm_train_state_crosses_convert_both_ways(opt_name):
    """A jamba train state after two steps, as numpy (the reference's
    tree) and back: every tensor bitwise, the per-layer views of each
    stack rows of one tensor."""
    cfg = get_config("jamba-v0.1-52b").reduced()
    opt = make_optimizer(opt_name, 1e-2)
    state = step.init_train_state(torch.Generator().manual_seed(0), cfg,
                                  None, opt, device="cpu")
    fn = step.make_train_step(cfg, None, opt)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen)
    for _ in range(2):
        state, _ = fn(state, {"tokens": tokens, "labels": tokens}, gen)
    np_params, np_opt, np_sampler, n = convert.train_state_to_jax(state)
    jopt = jmake_optimizer(opt_name, 1e-2)
    want = jax.eval_shape(jopt.init, jax.tree_util.tree_map(
        jnp.asarray, np_params))
    assert jax.tree_util.tree_structure(np_opt) == \
        jax.tree_util.tree_structure(want)
    back = convert.train_state_from_jax(np_params, np_opt, np_sampler, n,
                                        cfg, device="cpu")
    assert back.step == state.step == 2
    for (k, a), (k2, b) in zip(state.params.named_parameters(),
                               back.params.named_parameters()):
        assert k == k2 and torch.equal(a, b), k
    flat_a = jax.tree_util.tree_leaves(state.opt_state)
    flat_b = jax.tree_util.tree_leaves(back.opt_state)
    assert jax.tree_util.tree_structure(state.opt_state) == \
        jax.tree_util.tree_structure(back.opt_state)
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and torch.equal(a, b)
