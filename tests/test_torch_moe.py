"""The port's MoE FFN (repro_torch.models.moe) against the JAX package's
(repro.models.moe), mesh-free: dbrx-132b.reduced() (softmax routing, 4
experts top-2, every layer) and deepseek-v3-671b.reduced(mla=False,
mtp=False) (sigmoid scoring plus router_bias, one shared expert, a first
dense layer).

Weights come from the reference's ``init_moe`` (a nonzero router_bias
drawn with numpy); tokens' activations from numpy.  Routing ids and slots
must be EQUAL; weights, y and aux within 1e-5 x max|reference| (fp32,
summation order).  The reference's slots are read off its own dispatch: its
``_expert_compute`` is swapped for a recorder of the (E, capacity, d)
slots it is given, each token's first feature its id + 1.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as JMOE
from repro.sharding.rules import local_ctx
from repro_torch.configs import ArchConfig, get_config
from repro_torch.models import moe as MOE

torch.set_num_threads(1)

CTX = local_ctx()
T = 24


def _configs(arch: str, **over):
    if arch == "deepseek-v3-671b":
        # the port has no deepseek config yet (MLA and mtp: ROADMAP.md A16)
        jcfg = jget_config(arch).reduced(mla=False, mtp=False, **over)
        return jcfg, ArchConfig(**dataclasses.asdict(jcfg))
    return jget_config(arch).reduced(**over), get_config(arch).reduced(
        **over)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _params(jcfg, seed=0):
    jp = jax.tree_util.tree_map(np.asarray, JMOE.init_moe(
        jax.random.PRNGKey(seed), jcfg))
    if "router_bias" in jp:
        jp["router_bias"] = _normal(seed + 1, jp["router_bias"].shape, 0.05)
    return (jax.tree_util.tree_map(jnp.asarray, jp),
            jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), jp))


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


ARCHS = ["dbrx-132b", "deepseek-v3-671b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_route(arch):
    jcfg, cfg = _configs(arch)
    jp, tp = _params(jcfg)
    x = _normal(2, (T, cfg.d_model))
    jids, jw, jaux = JMOE._route(jp, jnp.asarray(x), jcfg)
    ids, w, aux = MOE._route(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(w.numpy(), jw)
    _close(aux.numpy(), jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_tie_goes_to_the_lowest_expert(arch):
    """Experts 1 and 3 score every token alike, above 0 and 2: both sides
    rank expert 1 first."""
    jcfg, cfg = _configs(arch)
    jp, tp = _params(jcfg)
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[:, 1] = router[:, 3] = 0.05
    x = np.abs(_normal(3, (T, cfg.d_model)))
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    if "router_bias" in jp:
        jp["router_bias"] = jnp.zeros_like(jp["router_bias"])
        tp["router_bias"] = torch.zeros_like(tp["router_bias"])
    jids = np.asarray(JMOE._route(jp, jnp.asarray(x), jcfg)[0])
    ids = MOE._route(tp, torch.from_numpy(x), cfg)[0].numpy()
    np.testing.assert_array_equal(ids, jids)
    assert (ids[:, 0] == 1).all() and (ids[:, 1] == 3).all()


def _reference_slots(jcfg, jp, x, cap):
    """(slot (T, k), keep (T, k)) of the reference's own dispatch."""
    seen = {}

    def record(xe, wg, wu, wd, act):
        seen["xe"] = np.asarray(xe)
        return xe

    ids = np.asarray(JMOE._route(jp, jnp.asarray(x), jcfg)[0])
    tagged = np.zeros_like(x)
    tagged[:, 0] = np.arange(1, x.shape[0] + 1)
    real = JMOE._expert_compute
    JMOE._expert_compute = record
    try:
        JMOE._dispatch_compute_combine(
            jnp.asarray(tagged), jnp.asarray(ids),
            jnp.ones(ids.shape, jnp.float32), jp["w_gate"], jp["w_up"],
            jp["w_down"], jcfg, 0, jcfg.n_experts, cap)
    finally:
        JMOE._expert_compute = real
    owner = seen["xe"][:, :, 0].astype(np.int64) - 1  # (E, cap), -1 empty
    slot = np.full(ids.shape, jcfg.n_experts * cap)
    for e, c in zip(*np.nonzero(owner >= 0)):
        t = owner[e, c]
        slot[t, list(ids[t]).index(e)] = e * cap + c
    return ids, slot, slot < jcfg.n_experts * cap


@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_slots_and_kept_mask(arch, factor):
    jcfg, cfg = _configs(arch, capacity_factor=factor)
    jp, tp = _params(jcfg)
    x = _normal(4, (T, cfg.d_model))
    cap = MOE.capacity(T, cfg)
    ids, want_slot, want_keep = _reference_slots(jcfg, jp, x, cap)
    slot, keep = MOE._slots(torch.from_numpy(ids.copy()), cfg.n_experts,
                            cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    if factor < 1:
        assert (~want_keep).sum() > 0  # the reference drops some


@pytest.mark.parametrize("factor", [1.25, 0.5, 16.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe(arch, factor):
    jcfg, cfg = _configs(arch, capacity_factor=factor)
    jp, tp = _params(jcfg)
    x = _normal(5, (2, T // 2, cfg.d_model))
    jy, jaux = jax.jit(lambda p, x: JMOE.apply_moe(p, x, jcfg, CTX))(
        jp, jnp.asarray(x))
    y, aux = MOE.apply_moe(tp, torch.from_numpy(x), cfg)
    _close(y.numpy(), jy)
    _close(aux.numpy(), jaux)


def test_capacity_matches_reference_rule():
    jcfg, cfg = _configs("dbrx-132b")
    for t, factor in ((2048, 1.25), (4, 1.25), (24, 0.5), (7, 16.0)):
        c = dataclasses.replace(cfg, capacity_factor=factor)
        want = int(max(cfg.moe_top_k, np.ceil(
            t * cfg.moe_top_k / cfg.n_experts * factor)))
        assert MOE.capacity(t, c) == want
    jamba = get_config("jamba-v0.1-52b")
    assert MOE.capacity(2048, jamba) == 320 and MOE.capacity(4, jamba) == 2


def test_mesh_branch_raises():
    jcfg, cfg = _configs("dbrx-132b")
    _, tp = _params(jcfg)
    with pytest.raises(NotImplementedError, match="A17"):
        MOE.apply_moe(tp, torch.zeros((1, 2, cfg.d_model)), cfg,
                      types.SimpleNamespace(mesh="m"))
