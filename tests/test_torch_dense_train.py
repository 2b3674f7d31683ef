"""Training the dense transformer family in the port against the JAX
package, at ``reduced()`` sizes (fp32, d 64, 4 layers, 4 / 2 heads of 16,
vocab 512) on the CPU.

* The attention's gradients: ``ops.flash_attention`` under autograd (the
  plain version on the CPU; the CUDA kernels' backward is held against the
  same plain version on the card by ``chip_smoke.py``) against
  ``jax.grad`` of the reference's ``layers.chunked_attention``, causal and
  not, GQA, ragged S: within 1e-5 x max|ref| (fp32, summation order).
* ``hidden_states`` and every parameter's gradient of starcoder2-3b,
  llama3-8b, qwen2-72b (``qkv_bias``) and chameleon-34b (``qk_norm``)
  against ``jax.grad`` of the reference's ``transformer.hidden_states``,
  with nonzero norm biases, QKV biases and qk-norm scales: within 1e-4 x
  max|ref| (fp32 through four layers).
* One starcoder2-3b train step at fixed shared negatives ``(h, labels,
  neg_ids, logq)``: loss within 1e-5 relative, parameters after clip +
  AdamW within 1e-5 (rtol and atol).
* The dense train state through checkpoints: the reference's restores in
  the port and the port's in the reference, equal keys, bitwise arrays,
  in fp32 and bf16; ``fit`` with a checkpoint directory.

Inputs come from numpy seeds; the JAX side runs under ``jax.jit``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.core import estimators as jest
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import transformer as jtf
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim.transform import apply_updates as japply_updates
from repro.sharding.rules import local_ctx
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import estimators
from repro_torch.data.pipeline import batch_iterator_for
from repro_torch.kernels import ops
from repro_torch.models import api, transformer
from repro_torch.optim import make_optimizer
from repro_torch.optim.transform import apply_updates
from repro_torch.train import loop, step

torch.set_num_threads(1)

CTX = local_ctx()
B, S = 2, 12
ATTN_TOL = 1e-5
MODEL_TOL = 1e-4
STEP_TOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(got, want, tol, msg=""):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, msg
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{msg}: max |got - want| {err} > {bound}"


# --- the attention's gradients -----------------------------------------------


def _jgrad_fn(causal: bool, chunk: int):
    def loss(q, k, v, do):
        out = JL.chunked_attention(q, k, v, causal=causal, chunk=chunk)
        return jnp.sum(out * do)
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))


_JGRADS = {}


@pytest.mark.parametrize("b,s,h,kv,hd,chunk", [
    (2, 12, 4, 2, 16, 5),     # GQA 2:1, ragged over chunks
    (1, 13, 4, 1, 8, 4),      # GQA 4:1 (MQA), ragged S
    (2, 9, 2, 2, 16, 16),     # MHA, one chunk
    (1, 17, 6, 2, 32, 8),     # group 3
])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_grads_match_jax(b, s, h, kv, hd, chunk, causal):
    q, k, v, do = (_normal(i, shape) for i, shape in enumerate(
        [(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd)]))
    key = (causal, chunk)
    if key not in _JGRADS:
        _JGRADS[key] = _jgrad_fn(causal, chunk)
    want = _JGRADS[key](*(jnp.asarray(x) for x in (q, k, v, do)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        _close(g.numpy(), w, ATTN_TOL, f"d{name}")


# --- the backbone: hidden states and every parameter gradient ---------------

MODELS = ("starcoder2-3b", "llama3-8b", "qwen2-72b", "chameleon-34b")


def _perturbed(np_params, seed):
    """Norm biases and scales, QKV biases and qk-norm scales made nonzero
    and away from 1 (the reference initialises them at 0 and 1)."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if name in ("bias", "bq", "bk", "bv"):
            return (rng.normal(size=node.shape) * 0.1).astype(node.dtype)
        if name == "scale":
            return (1.0 + rng.normal(size=node.shape) * 0.1
                    ).astype(node.dtype)
        return node
    return walk(np_params)


@pytest.fixture(scope="module", params=MODELS)
def backbone(request):
    name = request.param
    jcfg = jget_config(name).reduced()
    cfg = get_config(name).reduced()
    jp = jax.jit(lambda key: japi.init_params(key, jcfg, CTX))(
        jax.random.PRNGKey(0))
    np_params = _perturbed(_np_tree(jp), 1)
    return name, jcfg, cfg, np_params


@pytest.mark.parametrize("name", MODELS + ("mistral-nemo-12b",))
def test_config_matches_reference(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
        jget_config(name))
    assert dataclasses.asdict(get_config(name).reduced()) == \
        dataclasses.asdict(jget_config(name).reduced())


def test_hidden_states_and_param_grads_match_jax(backbone):
    """h and d(sum(h * r))/d(every parameter), StackedLM against the
    reference's stacked tree, leaf for leaf."""
    name, jcfg, cfg, np_params = backbone
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    r = _normal(3, (B, S, cfg.d_model))

    def jloss(params):
        h, _ = jtf.hidden_states(params, tokens, jcfg, CTX)
        return jnp.sum(h * r), h
    (_, jh), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, np_params))

    model = transformer.StackedLM(cfg, "cpu", tree=convert.params_from_jax(
        np_params, cfg, device="cpu"))
    h, aux = transformer.hidden_states(model, torch.from_numpy(tokens), cfg)
    assert float(aux) == 0.0
    _close(h.detach().numpy(), jh, MODEL_TOL, f"{name} h")
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(torch.sum(h * torch.from_numpy(r)),
                                list(named.values()), allow_unused=True)
    got = convert.named_to_jax(model, {  # the head is not in the backbone
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(named.items(), grads)})
    want = _np_tree(jgrads)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        _close(g, w, MODEL_TOL, f"{name} grad {jax.tree_util.keystr(path)}")


def test_dense_lm_module_shares_the_tree_and_stacks_back(backbone):
    """A StackedLM's parameters are views of the stacked tree (no copy), and
    convert stacks them back into the reference's tree exactly."""
    name, _, cfg, np_params = backbone
    tree = convert.params_from_jax(np_params, cfg, device="cpu")
    model = transformer.StackedLM(cfg, "cpu", tree=tree)
    wq = tree["segments"][0]["attn"]["wq"]
    layer1 = model.tree()["segments"][0][1]["attn"]["wq"]
    assert layer1.data_ptr() == wq[1].data_ptr()
    back = convert.params_to_jax(model)
    for (p1, a), (p2, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(np_params)[0]):
        assert p1 == p2
        np.testing.assert_array_equal(a, b)
    meta = api.abstract_params(cfg)
    assert sorted((n, p.shape, p.dtype)
                  for n, p in meta.named_parameters()) == \
        sorted((n, p.shape, p.dtype) for n, p in model.named_parameters())
    assert all(p.device.type == "meta" for p in meta.parameters())


# --- one train step at fixed negatives, then clip + AdamW --------------------

STEP_CFG = "starcoder2-3b"


#: AdamW's eps in the step test.  The key bias's components that RoPE
#: barely rotates over 12 positions (its lowest frequencies) shift every
#: score of a query alike, which the softmax ignores: their gradients are
#: ~1e-9, rounding noise on both sides, which AdamW's first step at eps
#: 1e-8 would turn into +-lr; at 1e-3 the comparison measures the update,
#: not the noise.
STEP_EPS = 1e-3


@pytest.fixture(scope="module")
def ref_state():
    jcfg = jget_config(STEP_CFG).reduced()
    jopt = jmake_optimizer("adamw", 1e-2, eps=STEP_EPS)
    state = jax.jit(lambda key: jstep.init_train_state(key, jcfg, CTX, jopt,
                                                       max_len=8))(
        jax.random.PRNGKey(0))
    params = _perturbed(_np_tree(state.params), 4)
    return jcfg, jopt, dataclasses.replace(
        state, params=jax.tree_util.tree_map(jnp.asarray, params))


def test_train_step_at_fixed_negatives_matches_jax(ref_state):
    jcfg, jopt, jstate = ref_state
    cfg = get_config(STEP_CFG).reduced()
    opt = make_optimizer("adamw", 1e-2, eps=STEP_EPS)
    mine = convert.train_state_from_jax(
        _np_tree(jstate.params), _np_tree(jstate.opt_state),
        {"stats": _np_tree(jstate.sampler_state.stats),
         "const": _np_tree(jstate.sampler_state.const)}, 0, cfg,
        device="cpu")
    assert isinstance(mine.params, transformer.StackedLM)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch_np = {"tokens": tokens, "labels": labels}
    m = cfg.m_negatives
    neg = rng.choice(cfg.vocab_size, m, replace=False).astype(np.int32)
    logq = np.log(rng.uniform(1e-4, 1e-2, m)).astype(np.float32)

    def jloss(params):
        hh, lab, _ = japi.backbone_hidden(params, batch_np, jcfg, CTX)
        return jnp.mean(jest.loss_from_embeddings(
            jest.make_estimator(jcfg.estimator),
            japi.head_table(params, jcfg), hh, lab, neg, logq,
            abs_mode=jcfg.abs_softmax))

    @jax.jit
    def jstep_fn(params, opt_state):
        loss, grads = jax.value_and_grad(jloss)(params)
        upd, opt_state = jopt.update(grads, opt_state, params)
        return loss, japply_updates(params, upd)
    jl, jparams = jstep_fn(jstate.params, jstate.opt_state)

    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in batch_np.items()}
    hh, lab, _ = api.backbone_hidden(mine.params, batch, cfg)
    loss = torch.mean(estimators.loss_from_embeddings(
        estimators.make_estimator(cfg.estimator),
        api.head_table(mine.params, cfg), hh, lab,
        torch.from_numpy(neg.astype(np.int64)), torch.from_numpy(logq),
        abs_mode=cfg.abs_softmax, impl=cfg.head_impl))
    params = step.param_dict(mine.params)
    grads = torch.autograd.grad(loss, list(params.values()))
    _close(loss.item(), float(jl), STEP_TOL, "loss")
    upd, _ = opt.update(dict(zip(params, grads)), mine.opt_state, params)
    apply_updates(params, upd)
    got = convert.params_to_jax(mine.params)
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(_np_tree(jparams))[0]):
        np.testing.assert_allclose(g, w, rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=jax.tree_util.keystr(path))


# --- checkpoints across the two packages -------------------------------------


def _flat_np(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_checkpoints_cross_both_ways(dtype, tmp_path):
    """The reference's dense train state saved by its manager restores in
    the port (template: abstract_train_state on meta) under the same keys,
    arrays bitwise; the port's save of it restores in the reference
    bitwise.  bf16 leaves travel as the 2-byte voids numpy writes."""
    jcfg = jget_config(STEP_CFG).reduced(dtype=dtype, param_dtype=dtype)
    cfg = get_config(STEP_CFG).reduced(dtype=dtype, param_dtype=dtype)
    jopt = jmake_optimizer("adamw", 1e-2)
    opt = make_optimizer("adamw", 1e-2)
    jstate = jax.jit(lambda key: jstep.init_train_state(key, jcfg, CTX, jopt,
                                                        max_len=8))(
        jax.random.PRNGKey(1))
    jdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    JCheckpointManager(jdir).save(3, jstate, extra={"step": 3},
                                  blocking=True)
    mine, extra = CheckpointManager(jdir).restore(
        like=step.abstract_train_state(cfg, None, opt), device="cpu")
    assert extra == {"step": 3} and mine.step == int(jstate.step)
    assert isinstance(mine.params, transformer.StackedLM)
    assert all(p.dtype == getattr(torch, dtype)
               for p in mine.params.parameters()
               if p.dim() > 1)
    want = dict(manager_mod._flatten(mine))
    with np.load(f"{jdir}/step_00000003/arrays.npz") as npz:
        assert sorted(npz.files) == sorted(want)
        for k in npz.files:
            assert npz[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(want[k], npz[k], err_msg=k)
    CheckpointManager(pdir).save(3, mine, extra={"step": 3}, blocking=True)
    with np.load(f"{pdir}/step_00000003/arrays.npz") as npz:
        assert sorted(npz.files) == sorted(want)
        for k in npz.files:
            assert npz[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(npz[k], want[k], err_msg=k)
    if dtype == "float32":  # the reference cannot place |V2 arrays
        back, jextra = JCheckpointManager(pdir).restore(like=jstate)
        assert jextra == {"step": 3}
        got, ref = _flat_np(back), _flat_np(jstate)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_fit_with_checkpoints_and_restart(tmp_path):
    """Three fit steps of starcoder2-3b reduced with the config's default
    sampler (block-quadratic-shared), checkpoints every 2: the final state
    restores bitwise, a relaunch resumes from it, and the in-loop save of
    the last step is left to the final one."""
    cfg = get_config(STEP_CFG).reduced()
    opt = make_optimizer("adamw", 1e-2)
    ckpt = str(tmp_path / "ckpt")
    data = batch_iterator_for(cfg, None, 2, 8, seed=0, device="cpu")
    res = loop.fit(cfg, None, opt, data, 4, checkpoint_dir=ckpt,
                   checkpoint_every=2, log_every=0, device="cpu")
    assert len(res.losses) == 4 and np.isfinite(res.losses).all()
    mgr = CheckpointManager(ckpt)
    assert mgr.all_steps() == [2, 4]
    back, extra = mgr.restore(like=step.abstract_train_state(cfg, None, opt),
                              device="cpu")
    assert extra["step"] == 4
    for (n, a), (n2, b) in zip(res.state.params.named_parameters(),
                               back.params.named_parameters()):
        assert n == n2 and torch.equal(a, b), n
    again = loop.fit(cfg, None, opt, batch_iterator_for(
        cfg, None, 2, 8, seed=0, device="cpu"), 5, checkpoint_dir=ckpt,
        checkpoint_every=2, log_every=0, device="cpu")
    assert again.restored_from == 4 and len(again.losses) == 1


def test_dense_batches_are_the_lm_chain():
    """The dense branch of batch_iterator_for serves SyntheticLM's token
    chain, as the lstm branch does (and as the reference's LM branch)."""
    cfg = get_config(STEP_CFG).reduced()
    lstm = get_config("ptb-lstm").reduced(vocab_size=cfg.vocab_size)
    a = next(batch_iterator_for(cfg, None, 3, 7, seed=4, device="cpu"))
    b = next(batch_iterator_for(lstm, None, 3, 7, seed=4, device="cpu"))
    assert set(a) == {"tokens", "labels"}
    for k in a:
        assert torch.equal(a[k], b[k])
