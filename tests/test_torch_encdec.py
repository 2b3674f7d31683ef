"""whisper-large-v3's encoder-decoder in the port (``models/encdec.py``,
the encdec branches of ``api``, ``convert``, ``batch_iterator_for``, the
train step, the checkpoint manager and the engine) against the JAX
package, at ``reduced()`` sizes on the CPU, fp32: 2 encoder and 2 decoder
layers, d 64, 4 heads over 2 KV heads of 16, LayerNorm, GELU, learned
positions of MAX_LEN rows.

* The init tree in fp32 and bf16 (keys, shapes, dtypes), ``EncDec``'s
  parameter names, ``init_pos_embed`` and ``cross_kv``.
* ``encode``, ``decode_train`` (frames longer than tokens: Sf 20, S 9),
  ``init_dec_cache`` and ``decode_step`` (h and the self cache it writes
  in place) against the reference's, within 1e-4 x max|ref| (fp32
  through four layers, the tolerance of ``test_torch_deepseek.py``); a
  chain of decode steps against the teacher-forced decoder, the
  reference's ``tests/test_serve.py`` case (its 2e-3).
* ``backbone_hidden``'s encdec rows (aux 0), ``convert`` both ways
  (params, an ``EncDec``, the decoder cache, the ``chain(clip, adamw)``
  and ``chain(clip, adafactor)`` train states) bitwise, Adafactor's state
  in the reference's stacked shapes.
* One train step at fixed shared negatives with clip + AdamW: the loss
  and every gradient within 1e-5 x max|ref|, every parameter and moment
  after the step within 1e-5; remat bitwise equal to the plain path;
  checkpoints written by either package restored by the other; ``fit``;
  the three engine steps against the reference engine's tokens.

Weights come from the reference's ``init_params`` (norm scales and biases
perturbed off their constant inits); frames, tokens and the other inputs
from numpy seeds.  The JAX side runs under ``jax.jit``, each of its
functions jitted once here.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.core import estimators as jest
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.models import layers as JL
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim.transform import apply_updates as japply_updates
from repro.serve import engine as jengine
from repro.sharding.rules import local_ctx
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import estimators
from repro_torch.data.pipeline import batch_iterator_for
from repro_torch.models import api, encdec
from repro_torch.models import layers as L
from repro_torch.optim import make_optimizer
from repro_torch.optim.transform import apply_updates
from repro_torch.serve import engine, retrieval
from repro_torch.train import loop, step

torch.set_num_threads(1)

ARCH = "whisper-large-v3"
CTX = local_ctx()
JCFG = jget_config(ARCH).reduced()
CFG = get_config(ARCH).reduced()
#: batch, frames and tokens: the frames longer than the tokens, as
#: whisper's 1,500 frames are than its 448 tokens
B, SF, S = 2, 20, 9
MAX_LEN = 32
TOL = 1e-4
STEP_TOL = 1e-5
#: AdamW's eps in the step comparison: a gradient element near 0 is
#: rounding noise on both sides, which AdamW's first step at eps 1e-8
#: would turn into +-lr; at 1e-3 the comparison measures the update, not
#: the noise (as ``test_torch_dense_train.py``'s)
STEP_EPS = 1e-3

_jinit = jax.jit(lambda k: japi.init_params(k, JCFG, CTX, max_len=MAX_LEN))
_jencode = jax.jit(lambda p, f: jencdec.encode(p, f, JCFG, CTX))
_jdecode_train = jax.jit(lambda p, t, e: jencdec.decode_train(p, t, e, JCFG,
                                                              CTX))
_jinit_cache = jax.jit(lambda p, e: jencdec.init_dec_cache(
    p, JCFG, B, MAX_LEN, e, CTX))
_jdecode_step = jax.jit(lambda p, t, c, pos: jencdec.decode_step(
    p, t, c, pos, JCFG, CTX))
_jbackbone = jax.jit(lambda p, b: japi.backbone_hidden(p, b, JCFG, CTX))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL, msg=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, msg
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{msg}: max |got - want| {err} > {bound}"


def _perturbed(np_params, seed):
    """Norm scales off 1 and norm biases off 0."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if name in ("scale", "bias"):
            base = 1.0 if name == "scale" else 0.0
            return (base + rng.normal(size=node.shape) * 0.1
                    ).astype(node.dtype)
        return node
    return walk(np_params)


@functools.lru_cache(maxsize=None)
def _model():
    """(reference params, port params)."""
    jp = _perturbed(_np_tree(_jinit(jax.random.PRNGKey(0))), 1)
    tp = convert.params_from_jax(jp, CFG, device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, jp), tp


def _frames(seed: int, s: int = SF) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(B, s, CFG.d_model)).astype(np.float32)


def _tokens(seed: int, s: int = S) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (B, s)).astype(np.int32)


def _long(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_reference(dtype):
    """Same keys, stacked shapes and dtypes as the reference's
    init_encdec; ``EncDec``'s parameter names on the meta device are the
    tree's, each stack's layers numbered."""
    jcfg = dataclasses.replace(JCFG, dtype=dtype, param_dtype=dtype)
    cfg = dataclasses.replace(CFG, dtype=dtype, param_dtype=dtype)
    want = jax.eval_shape(lambda k: japi.init_params(k, jcfg, CTX,
                                                     max_len=MAX_LEN),
                          jax.random.PRNGKey(0))
    got = api.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu", max_len=MAX_LEN)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
    assert not got["embed"]["table"][cfg.vocab_size:].any()
    meta = api.abstract_params(cfg, max_len=MAX_LEN)
    mod = encdec.EncDec(cfg, "cpu", tree=got)
    names = [n for n, _ in mod.named_parameters()]
    assert [n for n, _ in meta.named_parameters()] == names
    assert "dec_blocks.1.xattn.wk" in names and "enc_pos.table" in names
    assert mod.dec_blocks[1].xattn.wk.data_ptr() == \
        got["dec_blocks"]["xattn"]["wk"][1].data_ptr()


def test_init_pos_embed_and_cross_kv_match_reference():
    """``init_pos_embed`` draws a (max_pos, d) table of std 0.02 in the
    parameter dtype; ``cross_kv`` projects the encoder's states as the
    reference's does (no bias, no RoPE)."""
    cfg = dataclasses.replace(CFG, param_dtype="bfloat16")
    t = L.init_pos_embed(torch.Generator().manual_seed(0), cfg, 4096,
                         "cpu")["table"]
    assert t.shape == (4096, CFG.d_model) and t.dtype == torch.bfloat16
    assert abs(float(t.float().std()) - 0.02) < 1e-3
    jp, tp = _model()
    enc = _frames(3)
    jk, jv = JL.cross_kv(jax.tree_util.tree_map(
        lambda x: x[0], jp["dec_blocks"]["xattn"]), jnp.asarray(enc), JCFG,
        CTX)
    k, v = L.cross_kv({n: w[0] for n, w in tp["dec_blocks"]["xattn"].items()},
                      torch.from_numpy(enc), CFG)
    assert k.shape == (B, SF, CFG.n_kv_heads, CFG.resolved_head_dim)
    _close(k.numpy(), jk, 1e-6, "k")
    _close(v.numpy(), jv, 1e-6, "v")


def test_encode_and_decode_train_match_reference():
    jp, tp = _model()
    frames, tok = _frames(4), _tokens(5)
    jenc = _jencode(jp, jnp.asarray(frames))
    enc = encdec.encode(tp, torch.from_numpy(frames), CFG)
    assert enc.shape == (B, SF, CFG.d_model)
    _close(enc.numpy(), jenc, msg="encode")
    jh = _jdecode_train(jp, jnp.asarray(tok), jenc)
    h = encdec.decode_train(tp, _long(tok), enc, CFG)
    assert h.shape == (B, S, CFG.d_model)
    _close(h.numpy(), jh, msg="decode_train")


def test_cache_and_decode_step_match_reference():
    """``init_dec_cache``'s four (L, B, S, KV, hd) tensors and two
    ``decode_step``s: h, and the self cache written in place at pos (the
    same dict returned, the cross K/V untouched)."""
    jp, tp = _model()
    frames = _frames(6)
    jenc = _jencode(jp, jnp.asarray(frames))
    enc = encdec.encode(tp, torch.from_numpy(frames), CFG)
    jc = _jinit_cache(jp, jenc)
    cache = encdec.init_dec_cache(tp, CFG, B, MAX_LEN, enc)
    assert set(cache) == set(jc)
    for name in jc:
        _close(cache[name].numpy(), jc[name], msg=name)
    cross = cache["cross_k"].clone()
    tok = _tokens(7, 2)
    for t in range(2):
        pos = np.full((B,), t, np.int32)
        jh, jc = _jdecode_step(jp, jnp.asarray(tok[:, t:t + 1]), jc,
                               jnp.asarray(pos))
        h, cache2 = encdec.decode_step(tp, _long(tok[:, t:t + 1]), cache,
                                       _long(pos), CFG)
        assert cache2 is cache
        _close(h.numpy(), jh, msg=f"decode h at {t}")
        for name in jc:
            _close(cache[name].numpy(), jc[name], msg=f"{name} at {t}")
    assert torch.equal(cache["cross_k"], cross)
    assert not cache["self_k"][:, :, 2:].any()


def test_decode_matches_teacher_forced():
    """The reference's ``tests/test_serve.py`` case in the port: a chain
    of decode steps from ``init_dec_cache`` equals ``decode_train`` over
    the same tokens and encoder output (2e-3, its tolerance)."""
    _, tp = _model()
    enc = encdec.encode(tp, torch.from_numpy(_frames(8)), CFG)
    tok = _long(_tokens(9, 6))
    h_tf = encdec.decode_train(tp, tok, enc, CFG)
    cache = encdec.init_dec_cache(tp, CFG, B, MAX_LEN, enc)
    hs = []
    for t in range(tok.shape[1]):
        pos = torch.full((B,), t, dtype=torch.long)
        h_t, cache = encdec.decode_step(tp, tok[:, t:t + 1], cache, pos, CFG)
        hs.append(h_t[:, 0])
    np.testing.assert_allclose(torch.stack(hs, dim=1).numpy(),
                               h_tf.numpy(), rtol=2e-3, atol=2e-3)


def test_backbone_hidden_rows_with_frames_longer_than_tokens():
    jp, tp = _model()
    frames, tok, lab = _frames(10), _tokens(11), _tokens(12)
    jrows, jlabels, jaux = _jbackbone(jp, {
        "frames": jnp.asarray(frames), "tokens": jnp.asarray(tok),
        "labels": jnp.asarray(lab)})
    module = encdec.EncDec(CFG, "cpu", tree=tp)
    for params in (tp, module):
        rows, labels, aux = api.backbone_hidden(params, {
            "frames": torch.from_numpy(frames), "tokens": _long(tok),
            "labels": _long(lab)}, CFG)
        assert rows.shape == (B * S, CFG.d_model)
        _close(rows.detach().numpy(), jrows, msg="rows")
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
        assert float(aux) == float(jaux) == 0.0
    assert api.head_table(module, CFG) is module.head.w


def test_convert_params_and_caches_both_ways():
    jp, tp = _model()
    want = _np_tree(jp)
    for back in (convert.params_to_jax(tp), convert.params_to_jax(
            encdec.EncDec(CFG, "cpu", tree=tp))):
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(want)
        for g, w in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(want)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    jc = _np_tree(_jinit_cache(jp, _jencode(jp, jnp.asarray(_frames(13)))))
    tc = convert.caches_from_jax(jc, CFG, device="cpu")
    assert set(tc) == set(jc) and all(
        isinstance(c, torch.Tensor) for c in tc.values())
    back = convert.caches_to_jax(tc)
    for name in jc:
        np.testing.assert_array_equal(back[name], jc[name])
    with pytest.raises(ValueError, match="stacks"):
        convert.params_from_jax({**want, "dec_blocks": {}}, CFG,
                                device="cpu")


# --- train states, one step at fixed negatives ----------------------------


@functools.lru_cache(maxsize=None)
def _ref_state(opt_name: str, dtype: str = "float32"):
    jcfg = JCFG.reduced(dtype=dtype, param_dtype=dtype)
    jopt = jmake_optimizer(opt_name, 1e-2, **(
        {"eps": STEP_EPS} if opt_name == "adamw" else {}))
    state = jax.jit(lambda key: jstep.init_train_state(
        key, jcfg, CTX, jopt, max_len=MAX_LEN))(jax.random.PRNGKey(0))
    params = _perturbed(_np_tree(state.params), 4)
    return jopt, dataclasses.replace(
        state, params=jax.tree_util.tree_map(jnp.asarray, params))


def _train_state(jstate, cfg=CFG):
    return convert.train_state_from_jax(
        _np_tree(jstate.params), _np_tree(jstate.opt_state),
        {"stats": _np_tree(jstate.sampler_state.stats),
         "const": _np_tree(jstate.sampler_state.const)}, 3, cfg,
        device="cpu")


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_train_states_convert_both_ways(opt_name):
    """The chain(clip, adamw) and chain(clip, adafactor) states cross both
    ways bitwise in the reference's tree; Adafactor's statistics keep the
    reference's stacked shapes (``enc_blocks.<path>`` over the encoder's
    layers, a (layers, d) norm factored across them)."""
    _, jstate = _ref_state(opt_name)
    mine = _train_state(jstate)
    assert isinstance(mine.params, encdec.EncDec)
    if opt_name == "adafactor":
        v = mine.opt_state[1]["v"]
        assert v["enc_blocks.attn.wq"]["vr"].shape == (
            CFG.n_enc_layers, CFG.d_model)
        assert v["dec_blocks.xattn.wk"]["vc"].shape == (
            CFG.n_dec_layers, CFG.n_kv_heads * CFG.resolved_head_dim)
        assert v["enc_blocks.norm1.bias"]["vr"].shape == (CFG.n_enc_layers,)
        assert set(v["enc_norm.scale"]) == {"v"}
    params, opt_state, sampler, n = convert.train_state_to_jax(mine)
    assert n == 3
    for got, want in ((params, jstate.params),
                      (opt_state, jstate.opt_state),
                      (sampler["stats"], jstate.sampler_state.stats)):
        want = _np_tree(want)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g, w)


def _batch_np(seed):
    rng = np.random.default_rng(seed)
    return {"frames": rng.normal(size=(B, SF, CFG.d_model)).astype(
                np.float32),
            "tokens": rng.integers(0, CFG.vocab_size, (B, S)).astype(
                np.int32),
            "labels": rng.integers(0, CFG.vocab_size, (B, S)).astype(
                np.int32)}


def _torch_batch(batch_np):
    return {k: torch.from_numpy(v) if k == "frames"
            else torch.from_numpy(v.astype(np.int64))
            for k, v in batch_np.items()}


def test_train_step_at_fixed_negatives_matches_jax():
    """One step of each package from the same state at the same fixed
    shared negatives, clip + AdamW (eps STEP_EPS): the loss and every
    gradient within 1e-5 x max|ref|, the parameters and both moments
    after the step within 1e-5."""
    jopt, jstate = _ref_state("adamw")
    opt = make_optimizer("adamw", 1e-2, eps=STEP_EPS)
    mine = _train_state(jstate)
    batch_np = _batch_np(14)
    rng = np.random.default_rng(15)
    m = CFG.m_negatives
    neg = rng.choice(CFG.vocab_size, m, replace=False).astype(np.int32)
    logq = np.log(rng.uniform(1e-4, 1e-2, m)).astype(np.float32)

    def jloss(params):
        hh, lab, _ = japi.backbone_hidden(params, batch_np, JCFG, CTX)
        return jnp.mean(jest.loss_from_embeddings(
            jest.make_estimator(JCFG.estimator),
            japi.head_table(params, JCFG), hh, lab, neg, logq,
            abs_mode=JCFG.abs_softmax))

    @jax.jit
    def jstep_fn(params, opt_state):
        loss, grads = jax.value_and_grad(jloss)(params)
        upd, opt_state = jopt.update(grads, opt_state, params)
        return loss, grads, japply_updates(params, upd), opt_state
    jl, jgrads, jparams, jopt_state = jstep_fn(jstate.params,
                                               jstate.opt_state)

    hh, lab, _ = api.backbone_hidden(mine.params, _torch_batch(batch_np),
                                     CFG)
    loss = torch.mean(estimators.loss_from_embeddings(
        estimators.make_estimator(CFG.estimator),
        api.head_table(mine.params, CFG), hh, lab,
        torch.from_numpy(neg.astype(np.int64)), torch.from_numpy(logq),
        abs_mode=CFG.abs_softmax, impl=CFG.head_impl))
    params = step.param_dict(mine.params)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    _close(loss.item(), float(jl), STEP_TOL, "loss")
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(convert.named_to_jax(
                mine.params, grads))[0],
            jax.tree_util.tree_flatten_with_path(_np_tree(jgrads))[0]):
        _close(g, w, STEP_TOL, "grad " + jax.tree_util.keystr(path))
    # the port's clip scales its input in place: the step gets copies
    upd, opt_state = opt.update({k: g.clone() for k, g in grads.items()},
                                mine.opt_state, params)
    apply_updates(params, upd)
    after = dataclasses.replace(mine, opt_state=opt_state)
    got_p, got_o, _, _ = convert.train_state_to_jax(after)
    for got, want in ((got_p, jparams), (got_o, jopt_state)):
        for (path, g), (_, w) in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree_util.tree_flatten_with_path(_np_tree(want))[0]):
            np.testing.assert_allclose(
                np.asarray(g, np.float32), np.asarray(w, np.float32),
                rtol=STEP_TOL, atol=STEP_TOL,
                err_msg=jax.tree_util.keystr(path))


def test_remat_path_agrees_bitwise():
    """Each encoder and decoder layer checkpointed (``cfg.remat``) or not:
    the same rows and gradients, bit for bit."""
    _, tp = _model()
    batch = _torch_batch(_batch_np(16))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(CFG, remat=remat)
        model = encdec.EncDec(cfg, "cpu", tree=convert.params_from_jax(
            convert.params_to_jax(tp), cfg, device="cpu"))
        rows, _, _ = api.backbone_hidden(model, batch, cfg)
        r = torch.from_numpy(np.random.default_rng(17).normal(
            size=rows.shape).astype(np.float32))
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(torch.sum(rows * r),
                                    list(named.values()), allow_unused=True)
        out.append((rows.detach(), {k: g for k, g in zip(named, grads)
                                    if g is not None}))
    (r0, g0), (r1, g1) = out
    # every parameter but the head (the rows are its input) has one
    assert set(g0) == set(dict(model.named_parameters())) - {"head.w"}
    assert torch.equal(r0, r1) and g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def _flat_np(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("opt_name,dtype", [
    ("adamw", "float32"), ("adamw", "bfloat16"), ("adafactor", "float32")])
def test_checkpoints_cross_both_ways(opt_name, dtype, tmp_path):
    """The reference's manager's save restores in the port (template:
    ``abstract_train_state`` on meta at the same ``max_len``) under the
    same keys, arrays bitwise; the port's save of it has the same keys
    and arrays, and (fp32: the reference cannot place the ``|V2`` arrays
    numpy writes for bf16) restores in the reference bitwise."""
    _, jstate = _ref_state(opt_name, dtype)
    cfg = CFG.reduced(dtype=dtype, param_dtype=dtype)
    opt = make_optimizer(opt_name, 1e-2)
    jdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    JCheckpointManager(jdir).save(3, jstate, extra={"step": 3},
                                  blocking=True)
    mine, extra = CheckpointManager(jdir).restore(
        like=step.abstract_train_state(cfg, None, opt, max_len=MAX_LEN),
        device="cpu")
    assert extra == {"step": 3} and isinstance(mine.params, encdec.EncDec)
    want = dict(manager_mod._flatten(mine))
    assert ".params/dec_blocks/xattn/wk" in want
    with np.load(f"{jdir}/step_00000003/arrays.npz") as npz:
        assert sorted(npz.files) == sorted(want)
        for k in npz.files:
            assert npz[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(want[k], npz[k], err_msg=k)
    CheckpointManager(pdir).save(3, mine, extra={"step": 3}, blocking=True)
    with np.load(f"{pdir}/step_00000003/arrays.npz") as npz:
        assert sorted(npz.files) == sorted(want)
        for k in npz.files:
            np.testing.assert_array_equal(npz[k], want[k], err_msg=k)
    if dtype == "float32":
        back, jextra = JCheckpointManager(pdir).restore(like=jstate)
        assert jextra == {"step": 3}
        got, ref = _flat_np(back), _flat_np(jstate)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_batches_and_fit():
    """``batch_iterator_for`` gives SyntheticLM's chain with frames (B,
    seq_len, d) in ``cfg.dtype``, a pure function of (seed, step); three
    ``fit`` steps (the config's sampler, clip + AdamW) give finite losses
    and move every parameter, both position tables included."""
    data = batch_iterator_for(CFG, None, 4, 8, seed=3, device="cpu")
    first = next(data)
    assert first["frames"].shape == (4, 8, CFG.d_model)
    assert first["frames"].dtype == torch.float32
    assert first["tokens"].shape == first["labels"].shape == (4, 8)
    assert torch.equal(first["tokens"][:, 1:], first["labels"][:, :-1])
    again = next(batch_iterator_for(CFG, None, 4, 8, seed=3, device="cpu"))
    assert all(torch.equal(first[k], again[k]) for k in first)
    bf = batch_iterator_for(CFG.reduced(dtype="bfloat16"), None, 4, 8,
                            device="cpu")
    assert next(bf)["frames"].dtype == torch.bfloat16
    start = api.init_module(CFG, torch.Generator("cpu").manual_seed(0),
                            device="cpu", max_len=16)
    res = loop.fit(CFG, None, make_optimizer("adamw", 1e-2),
                   batch_iterator_for(CFG, None, 4, 8, device="cpu"), 3,
                   log_every=0, max_len=16, device="cpu")
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    assert isinstance(res.state.params, encdec.EncDec)
    still = [n for (n, a), b in zip(start.named_parameters(),
                                    res.state.params.parameters())
             if torch.equal(a, b)]
    assert still == []


def test_engine_steps_match_the_reference_engine():
    """Prefill (encode, the cross K/V, the first step from token 0 at
    position 0), greedy decode steps and top-k through a RetrievalIndex at
    full beam: the greedy tokens equal the reference engine's; the
    index's top-k equals the dense top-k, its top-1 the greedy token."""
    jp, tp = _model()
    steps, k = 4, 5
    frames = _frames(18)
    jtok, jc = jax.jit(jengine.make_prefill_step(JCFG, CTX, MAX_LEN))(
        jp, {"frames": jnp.asarray(frames)})
    tok, cache = engine.make_prefill_step(CFG, None, MAX_LEN)(
        tp, {"frames": torch.from_numpy(frames)})
    assert set(cache) == {"self_k", "self_v", "cross_k", "cross_v"}
    jdec = jax.jit(jengine.make_decode_step(JCFG, CTX))
    decode = engine.make_decode_step(CFG, None)
    for i in range(steps):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        pos = np.full((B,), 1 + i, np.int32)
        jtok, jc = jdec(jp, jtok[:, None], jc, jnp.asarray(pos))
        tok, cache = decode(tp, tok[:, None].long(), cache, _long(pos))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    pos = torch.full((B,), 1 + steps, dtype=torch.long)
    index = retrieval.build_index(api.head_table(tp, CFG))
    assert index.num_leaves_shard > 1
    ids, logits, _ = engine.make_topk_step(CFG, None, k, index=index)(
        tp, tok[:, None].long(), cache, pos)
    dids, dlogits, _ = engine.make_topk_step(CFG, None, k)(
        tp, tok[:, None].long(), cache, pos)
    np.testing.assert_array_equal(ids.numpy(), dids.numpy())
    _close(logits.numpy(), dlogits.numpy(), 1e-5)
    nxt, _ = decode(tp, tok[:, None].long(), cache, pos)
    np.testing.assert_array_equal(ids[:, 0].numpy(), nxt.numpy())
