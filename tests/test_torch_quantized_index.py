"""The quantized serving index (``repro_torch.serve.quantized_index``,
``train/step.py``'s ``export_quantized_index`` and the quantized branch of
``serving_index_source``, the engine's dispatch and payload gauge) against
the JAX package's, on the CPU.

Tables and queries come from numpy seeds and go through both packages:

* the build: ``codes``, ``perm``, ``cnt`` and the int8 ``rows`` exactly
  equal, ``scale`` within 1 ulp (both divide the same fp32 absmax by 127),
  the codebooks within 1e-5 x max|ref| (k-means sums in another order);
* ``decode_topk``: ids equal and logits within 1e-5 x max|logit|, at a
  narrow beam and at full beam, int8 and fp32 rows;
* ``payload_bytes`` and ``recall_at_k`` equal to the reference's;
* indexes crossing both ways (``convert.index_from_jax`` /
  ``index_to_jax``) and a trained state's export;
* ``serving_index_source(quantized=True)`` surviving a torn checkpoint
  write, alone and behind an ``IndexRefresher`` and a ``ServingEngine``
  (the reference's ``tests/test_quantized_index.py`` cases);
* the engine's top-k step through the quantized index on llama3-8b
  reduced, against the reference's.
"""
import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.serve import engine as jengine
from repro.serve import quantized_index as jqi
from repro.sharding.rules import local_ctx
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.optim import make_optimizer
from repro_torch.serve import engine, quantized_index, retrieval
from repro_torch.serve.server import (
    IndexRefresher,
    ServingEngine,
    payload_bytes,
)
from repro_torch.train import step

torch.set_num_threads(1)

CTX = local_ctx()
LOGIT_TOL = 1e-5


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


_jbuild = jax.jit(jqi.build_quantized_index,
                  static_argnames=("codewords", "codebooks", "list_size",
                                   "bits", "vocab_size"))


_jdecode_jit = jax.jit(jqi.decode_topk, static_argnames=("k", "beam"))


def _jdecode(idx, h, k, beam):
    return _jdecode_jit(idx, h, k=k, beam=beam)


def _both(n, d, bits, seed=0, codewords=8, list_size=None, scale=0.3,
          vocab_size=None):
    w = _normal(seed, (n, d), scale)
    jidx = _jbuild(jnp.asarray(w), codewords=codewords, list_size=list_size,
                   bits=bits, vocab_size=vocab_size)
    idx = quantized_index.build_quantized_index(
        torch.from_numpy(w), codewords=codewords, list_size=list_size,
        bits=bits, vocab_size=vocab_size)
    return w, jidx, idx


@pytest.mark.parametrize("n,d,bits,list_size", [
    (1000, 16, 8, None), (256, 12, 8, None), (130, 16, 32, None),
    (700, 24, 8, 32), (500, 16, 32, 64)])
def test_build_matches_reference(n, d, bits, list_size):
    _, jidx, idx = _both(n, d, bits, seed=n, list_size=list_size)
    assert (idx.n, idx.tp, idx.v_shard, idx.bits) == (jidx.n, jidx.tp,
                                                     jidx.v_shard, jidx.bits)
    for f in ("codes", "perm", "cnt", "rows"):
        want = np.asarray(getattr(jidx, f))
        got = getattr(idx, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    want = np.asarray(jidx.scale)
    np.testing.assert_array_max_ulp(idx.scale.numpy(), want, maxulp=1)
    for f in ("c1", "c2"):
        want = np.asarray(getattr(jidx, f))
        np.testing.assert_allclose(
            getattr(idx, f).numpy(), want, rtol=0,
            atol=1e-5 * float(np.abs(want).max()), err_msg=f)


def test_int8_rows_round_half_to_even():
    """``_quantize_rows`` rounds as ``jnp.round``: halves to even."""
    rows = np.array([[[127.0, 0.5, 1.5, -2.5, 3.49, -0.5]]], np.float32)
    q, scale = quantized_index._quantize_rows(torch.from_numpy(rows), 8)
    jq, jscale = jqi._quantize_rows(jnp.asarray(rows), 8)
    assert q.tolist() == [[[127, 0, 2, -2, 3, 0]]]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize("bits", [8, 32])
@pytest.mark.parametrize("beam", [None, 3, 16])
def test_decode_topk_matches_reference(bits, beam):
    n, d, k = 1000, 16, 10
    w, jidx, idx = _both(n, d, bits, seed=7)
    h = _normal(8, (6, d))
    jids, jlog = _jdecode(jidx, jnp.asarray(h), k, beam)
    ids, logits = quantized_index.decode_topk(idx, torch.from_numpy(h), k,
                                              beam)
    assert ids.dtype == torch.int32 and logits.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jlog), rtol=0,
        atol=LOGIT_TOL * float(np.abs(np.asarray(jlog)).max()))


@pytest.mark.parametrize("n", [1000, 256, 130])
def test_fp32_full_beam_equals_dense_topk(n):
    """bits=32 at full beam scores every class exactly: the dense top-k."""
    w, _, idx = _both(n, 16, 32, seed=n)
    h = torch.from_numpy(_normal(1, (6, 16)))
    ids, logits = quantized_index.decode_topk(idx, h, 10)
    tids, tlog = retrieval.dense_topk(torch.from_numpy(w), h, 10)
    assert torch.equal(ids, tids)
    np.testing.assert_allclose(logits.numpy(), tlog.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_narrow_beam_logits_are_dequantized_dots():
    """What a narrow beam returns carries its exact dequantized logit."""
    w, _, idx = _both(512, 12, 8, seed=3, scale=0.4)
    h = torch.from_numpy(_normal(4, (5, 12)))
    ids, logits = quantized_index.decode_topk(idx, h, 8, beam=16)
    where = torch.argsort(idx.perm.long())  # original id -> packed position
    pos = where[ids.long()]
    rows = quantized_index._dequant(
        idx.rows.reshape(-1, 12)[pos], idx.scale.reshape(-1)[pos])
    want = torch.einsum("tkd,td->tk", rows, h)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.all(logits[:, :-1] >= logits[:, 1:])


@pytest.mark.parametrize("bits", [8, 32])
def test_payload_bytes_and_recall_match_reference(bits):
    w, jidx, idx = _both(1000, 16, bits, seed=11)
    assert payload_bytes(idx) == quantized_index.payload_bytes(idx) == \
        jqi.payload_bytes(jidx)
    h = _normal(12, (8, 16))
    for beam in (2, 8):
        assert quantized_index.recall_at_k(
            idx, torch.from_numpy(w), torch.from_numpy(h), 5, beam) == \
            pytest.approx(jqi.recall_at_k(jidx, jnp.asarray(w),
                                          jnp.asarray(h), 5, beam))


def test_int8_payload_is_about_a_quarter_of_fp32():
    w = torch.from_numpy(_normal(5, (4096, 64)))
    q8 = quantized_index.build_quantized_index(w, codewords=8, bits=8)
    q32 = quantized_index.build_quantized_index(w, codewords=8, bits=32)
    fp32 = retrieval.build_index(w)
    assert payload_bytes(q8) <= 0.3 * payload_bytes(q32)
    assert payload_bytes(q8) < payload_bytes(fp32)


def test_indexes_cross_both_ways():
    _, jidx, idx = _both(700, 16, 8, seed=2)
    fields = {f.name: np.asarray(getattr(jidx, f.name))
              if f.name in idx.TENSORS else getattr(jidx, f.name)
              for f in dataclasses.fields(jidx)}
    got = convert.index_from_jax(fields, device="cpu")
    assert isinstance(got, quantized_index.QuantizedRetrievalIndex)
    for f in idx.TENSORS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), fields[f])
    back = jqi.QuantizedRetrievalIndex(**{
        k: jnp.asarray(v) if k in idx.TENSORS else v
        for k, v in convert.index_to_jax(idx).items()})
    h = _normal(3, (4, 16))
    jids, _ = _jdecode(back, jnp.asarray(h), 5, None)
    ids, _ = quantized_index.decode_topk(idx, torch.from_numpy(h), 5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_mesh_raises():
    w = torch.zeros(64, 8)
    mesh = type("Ctx", (), {"mesh": "m"})()
    with pytest.raises(NotImplementedError, match="A17"):
        quantized_index.build_quantized_index(w, mesh)


# --- train -> serve: export and the checkpoint source ------------------------


def _tiny_cfg():
    return get_config("youtube-dnn").reduced(
        vocab_size=64, m_negatives=16, sampler_block=16,
        tower_dims=(32, 16))


def test_export_matches_a_build_of_the_head():
    cfg = _tiny_cfg()
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    state = step.init_train_state(torch.Generator().manual_seed(0), cfg,
                                  None, opt, device="cpu")
    got = step.export_quantized_index(state, cfg, None)
    head = api.head_table(state.params, cfg).detach()
    want = quantized_index.build_quantized_index(
        head, codewords=cfg.midx_codewords, list_size=cfg.sampler_block,
        bits=cfg.midx_bits, vocab_size=cfg.vocab_size)
    assert got.bits == 8 and got.rows.dtype == torch.int8
    for f in got.TENSORS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert step.export_quantized_index(state, cfg, None, bits=32).bits == 32


def _torn(path, step_no):
    torn = os.path.join(path, f"step_{step_no:08d}")
    os.makedirs(torn)
    with open(os.path.join(torn, "manifest.json"), "w") as f:
        json.dump({"step": step_no, "extra": {}, "keys": []}, f)


def test_index_source_survives_partial_write_and_retries(tmp_path):
    """A poll that races a torn write (manifest listed, arrays missing)
    reports nothing new, does not raise and does not mark the step
    served; the completed step ships as the int8 index."""
    cfg = _tiny_cfg()
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    state = step.init_train_state(torch.Generator().manual_seed(0), cfg,
                                  None, opt, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, state, blocking=True)
    poll = step.serving_index_source(str(tmp_path), cfg, None, opt,
                                     quantized=True, device="cpu")
    idx1, step1 = poll()
    assert step1 == 1 and isinstance(
        idx1, quantized_index.QuantizedRetrievalIndex)
    assert idx1.bits == cfg.midx_bits == 8 and idx1.rows.dtype == torch.int8
    assert poll() is None
    _torn(str(tmp_path), 2)
    assert poll() is None and poll() is None
    mgr.save(2, dataclasses.replace(state, step=state.step + 1),
             blocking=True)
    got = poll()
    assert got is not None and got[1] == 2
    fp32 = step.serving_index_source(str(tmp_path), cfg, None, opt,
                                     device="cpu")()[0]
    assert payload_bytes(got[0]) < payload_bytes(fp32)


def test_refresher_stays_alive_through_partial_write(tmp_path):
    """The refresher keeps polling through a torn step, ships it once it
    is complete, and the engine's payload gauge reads the int8 index's
    bytes."""
    cfg = _tiny_cfg()
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    state = step.init_train_state(torch.Generator().manual_seed(0), cfg,
                                  None, opt, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=3)
    _torn(str(tmp_path), 1)
    poll = step.serving_index_source(str(tmp_path), cfg, None, opt,
                                     quantized=True, device="cpu")
    k = 5
    head = api.head_table(state.params, cfg).detach()
    eng = ServingEngine(engine.make_decode_fn(cfg, None, head, k), 16, k,
                        buckets=(1, 2), device="cpu").start(warmup=False)
    ref = IndexRefresher(eng, poll, poll_s=0.02)
    ref.start()
    try:
        time.sleep(0.15)
        assert ref.is_alive() and ref.error is None and ref.swaps == 0
        mgr.save(1, state, blocking=True)
        deadline = time.time() + 10.0
        while ref.swaps == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert ref.swaps == 1, "completed step was never shipped"
        c = eng.counters()
        assert c["index_train_step"] == 1
        want = step.export_quantized_index(state, cfg, None)
        assert c["index_payload_bytes"] == payload_bytes(want)
        h = np.asarray(_normal(6, (16,)))
        res = eng.decode(h)
        ids, logits = quantized_index.decode_topk(want, torch.from_numpy(
            h[None]), k)
        assert res.ok and list(res.ids) == ids[0].tolist()
    finally:
        ref.stop()
        eng.stop()


# --- the engine's steps through the quantized index --------------------------

LM_K, LM_B, LM_S = 5, 2, 8


@pytest.fixture(scope="module")
def llama():
    jcfg = jget_config("llama3-8b").reduced()
    cfg = get_config("llama3-8b").reduced()
    jp = jax.jit(lambda key: japi.init_params(key, jcfg, CTX))(
        jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     cfg, device="cpu")
    return jcfg, cfg, jp, params


@pytest.mark.parametrize("bits,beam", [(32, None), (8, 4)])
def test_topk_step_through_the_index_matches_reference(llama, bits, beam):
    jcfg, cfg, jp, params = llama
    head = api.head_table(params, cfg)
    jidx = _jbuild(japi.head_table(jp, jcfg), codewords=8, bits=bits,
                   list_size=32, vocab_size=jcfg.vocab_size)
    idx = quantized_index.build_quantized_index(
        head, codewords=8, bits=bits, list_size=32,
        vocab_size=cfg.vocab_size)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_B, LM_S)).astype(np.int32)
    max_len = LM_S + 2
    jtok, jcaches = jax.jit(jengine.make_prefill_step(jcfg, CTX, max_len))(
        jp, {"tokens": tokens})
    tok, caches = engine.make_prefill_step(cfg, None, max_len)(
        params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    pos = np.full((LM_B,), LM_S, np.int32)

    def jstep_fn(p, index, t, c, ps):
        return jengine.make_topk_step(jcfg, CTX, LM_K, index=index,
                                      beam=beam)(p, t, c, ps)
    jids, jlog, _ = jax.jit(jstep_fn)(jp, jidx, jtok[:, None], jcaches, pos)
    ids, logits, _ = engine.make_topk_step(cfg, None, LM_K, index=idx,
                                           beam=beam)(
        params, tok[:, None].long(), caches, torch.from_numpy(pos).long())
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jlog), rtol=0,
        atol=LOGIT_TOL * float(np.abs(np.asarray(jlog)).max()))
    if bits == 32 and beam is None:  # exhaustive fp32: the greedy token
        dense, _, _ = engine.make_topk_step(cfg, None, 1)(
            params, tok[:, None].long(), engine.make_prefill_step(
                cfg, None, max_len)(params, {
                    "tokens": torch.from_numpy(tokens)})[1],
            torch.from_numpy(pos).long())
        assert torch.equal(ids[:, 0], dense[:, 0])
