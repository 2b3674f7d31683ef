"""The port's ServingEngine on the CPU (mirrors tests/test_serving_engine.py):
bucket padding, refresh under load, deadlines, the version-scoped cache,
counters, and the engine's answers against the JAX package's decode on the
same index (carried over by ``convert.index_from_jax``)."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import retrieval as jret
from repro.serve.quantized_index import payload_bytes as jpayload_bytes
from repro.serve.server import LatencyHistogram as JLatencyHistogram
from repro_torch import convert
from repro_torch.serve import retrieval
from repro_torch.serve.server import (
    IndexRefresher,
    LatencyHistogram,
    ServingEngine,
    payload_bytes,
)

torch.set_num_threads(1)

N, D, K = 256, 16, 5
_jbuild = jax.jit(jret.build_index)  # compiled once: eager ops compile each


def _table(seed: int) -> np.ndarray:
    """Clustered class-embedding table (mixture of a few directions)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, D))
    w = centers[rng.integers(0, 8, N)] + 0.3 * rng.normal(size=(N, D))
    return w.astype(np.float32)


def _decode_fn(head: np.ndarray):
    """(index, h) -> (ids, logits); index=None is the dense path."""
    w = torch.from_numpy(head)

    def decode(index, h):
        if index is None:
            return retrieval.dense_topk(w, h, K, n_valid=N)
        return retrieval.decode_topk(index, h, K, None)

    return decode


def _index(w: np.ndarray):
    return retrieval.build_index(w, device="cpu")


def _queries(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _engine(w, **kw) -> ServingEngine:
    return ServingEngine(_decode_fn(w), D, K, device="cpu", **kw)


def _ref_ids(index, h: np.ndarray) -> np.ndarray:
    ids, _ = retrieval.decode_topk(index, torch.from_numpy(h), K, None)
    return ids.numpy()


@pytest.mark.parametrize("use_index", [False, True], ids=["dense", "index"])
def test_bucket_padding_matches_jax_decode(use_index):
    """7 concurrent queries into buckets (4, 8): the non-divisible arrival
    pads up to 8, the masked rows leak into no answer, and every answer
    equals the JAX package's decode of the same query."""
    w = _table(0)
    h = _queries(1, 7)
    if use_index:
        jidx = _jbuild(jnp.asarray(w))
        fields = {f: np.asarray(getattr(jidx, f))
                  for f in retrieval.RetrievalIndex.TENSORS}
        index = convert.index_from_jax(
            dict(fields, n=jidx.n, tp=jidx.tp, v_shard=jidx.v_shard),
            device="cpu")
        ref_ids, ref_lg = jax.jit(jret.decode_topk, static_argnums=(2, 3))(
            jidx, jnp.asarray(h), K, None)
    else:
        index = None
        ref_ids, ref_lg = jret.dense_topk(jnp.asarray(w), jnp.asarray(h), K,
                                          n_valid=N)
    eng = _engine(w, buckets=(4, 8), max_wait_ms=5.0, index=index).start()
    try:
        futs = [eng.submit(h[i]) for i in range(7)]
        results = [f.result_wait(30.0) for f in futs]
    finally:
        eng.stop()
    for i, r in enumerate(results):
        assert r.ok, r.error
        np.testing.assert_array_equal(r.ids, np.asarray(ref_ids)[i])
        np.testing.assert_allclose(r.logits, np.asarray(ref_lg)[i],
                                   rtol=1e-5, atol=1e-5)
    c = eng.counters()
    assert c["completed"] == 7
    assert c["batch_real"] == 7
    assert c["batch_slots"] >= 7  # padded


def test_single_query_roundtrip_dense():
    w = _table(0)
    eng = _engine(w, buckets=(1, 4)).start()
    try:
        h = _queries(2, 1)[0]
        r = eng.decode(h)
        ref_ids, _ = retrieval.dense_topk(torch.from_numpy(w),
                                          torch.from_numpy(h[None]), K,
                                          n_valid=N)
        assert r.ok and r.index_version == 0 and not r.cached
        np.testing.assert_array_equal(r.ids, ref_ids.numpy()[0])
    finally:
        eng.stop()


def test_refresh_under_load_never_mixes_indexes():
    """Swap v0 -> v1 while 200 queries stream through: every answer is
    entirely v0's or entirely v1's, matches its reported version, and no
    request fails."""
    w0, w1 = _table(0), _table(7)
    idx0, idx1 = _index(w0), _index(w1)
    pool = _queries(3, 16)
    ref = {0: _ref_ids(idx0, pool), 1: _ref_ids(idx1, pool)}

    eng = _engine(w0, buckets=(2, 4, 8), max_wait_ms=1.0,
                  default_deadline_ms=30_000.0, index=idx0,
                  index_version=0).start()
    swapped = threading.Event()

    def swapper():
        time.sleep(0.03)  # let some of the stream run on v0
        eng.swap_index(idx1, version=1, train_step=1)
        swapped.set()

    th = threading.Thread(target=swapper)
    th.start()
    try:
        futs = []
        for i in range(200):
            futs.append((i % 16, eng.submit(pool[i % 16])))
            if i % 20 == 19:
                time.sleep(0.005)  # spread the stream across the swap
        results = [(pid, f.result_wait(60.0)) for pid, f in futs]
    finally:
        th.join(10.0)
        eng.stop()
    assert not th.is_alive()

    versions = set()
    for pid, r in results:
        assert r.ok, r.error
        assert r.index_version in (0, 1)
        versions.add(r.index_version)
        np.testing.assert_array_equal(r.ids, ref[r.index_version][pid])
    assert swapped.is_set()
    assert versions == {0, 1}, f"swap did not land mid-stream: {versions}"
    c = eng.counters()
    assert c["index_swaps"] == 1
    assert c["completed"] == 200 and c["expired"] == 0


def test_deadline_expiry_fails_fast():
    w = _table(0)
    eng = _engine(w, buckets=(1, 2))
    # submit BEFORE start so the request provably sits past its deadline
    fut = eng.submit(_queries(4, 1)[0], deadline_ms=1.0)
    time.sleep(0.05)
    eng.start()
    try:
        r = fut.result_wait(10.0)
        assert not r.ok and r.error == "deadline exceeded"
        assert r.ids is None
        live = eng.decode(_queries(5, 1)[0])  # engine still serves
        assert live.ok
        c = eng.counters()
        assert c["expired"] == 1 and c["completed"] == 1
        assert c["submitted"] == 2
    finally:
        eng.stop()


def test_stop_fails_pending():
    eng = _engine(_table(0))  # never started
    fut = eng.submit(_queries(6, 1)[0])
    eng.stop()
    r = fut.result_wait(1.0)
    assert not r.ok and r.error == "engine stopped"


def test_cache_hit_equivalence_and_swap_invalidation():
    w0, w1 = _table(0), _table(7)
    idx0, idx1 = _index(w0), _index(w1)
    h = _queries(8, 1)[0]
    ref0 = _ref_ids(idx0, h[None])[0]
    ref1 = _ref_ids(idx1, h[None])[0]

    eng = _engine(w0, buckets=(1, 2), cache_size=32, index=idx0,
                  index_version=0).start()
    try:
        r1 = eng.decode(h)
        assert r1.ok and not r1.cached
        np.testing.assert_array_equal(r1.ids, ref0)
        r2 = eng.decode(h)
        assert r2.ok and r2.cached, "identical query must hit the cache"
        np.testing.assert_array_equal(r2.ids, r1.ids)
        np.testing.assert_array_equal(r2.logits, r1.logits)
        assert r2.index_version == 0

        # version-scoped keys: the swap is an implicit full invalidation
        eng.swap_index(idx1, version=1)
        r3 = eng.decode(h)
        assert r3.ok and not r3.cached, "swap must invalidate cached answers"
        assert r3.index_version == 1
        np.testing.assert_array_equal(r3.ids, ref1)

        c = eng.counters()
        assert c["cache_hits"] == 1 and c["cache_misses"] == 2
        assert abs(c["cache_hit_rate"] - 1 / 3) < 1e-9
    finally:
        eng.stop()


def test_cache_quantization_buckets_nearby_queries():
    h = _queries(9, 1)[0]
    eng = _engine(_table(0), buckets=(1,), cache_size=8,
                  cache_quant=1e-2).start()
    try:
        r1 = eng.decode(h)
        r2 = eng.decode(h + 1e-4)  # within quantization bucket
        assert not r1.cached and r2.cached
        np.testing.assert_array_equal(r1.ids, r2.ids)
    finally:
        eng.stop()


def test_counters_staleness_and_payload_bytes():
    w = _table(0)
    idx = _index(w)
    assert payload_bytes(idx) == jpayload_bytes(_jbuild(jnp.asarray(w)))
    eng = _engine(w, buckets=(1, 2), index=idx, index_version=0,
                  index_train_step=100).start()
    try:
        for q in _queries(10, 4):
            eng.decode(q)
        eng.note_train_step(130)
        c = eng.counters()
        assert c["index_staleness_steps"] == 30
        assert c["index_payload_bytes"] == payload_bytes(idx)
        assert c["submitted"] == c["completed"] + c["expired"] == 4
        assert 0.0 < c["batch_occupancy"] <= 1.0
        assert c["latency_ms"]["count"] == 4
        assert c["latency_ms"]["p99"] >= c["latency_ms"]["p50"] > 0.0
        eng.swap_index(idx, version=1, train_step=130)
        assert eng.counters()["index_staleness_steps"] == 0
    finally:
        eng.stop()


def test_index_refresher_swaps_from_its_source():
    w0, w1 = _table(0), _table(7)
    idx1 = _index(w1)
    fresh = [(idx1, 5)]
    eng = _engine(w0, buckets=(1,), index=_index(w0)).start()
    ref = IndexRefresher(eng, lambda: fresh.pop() if fresh else None,
                         poll_s=0.01)
    ref.start()
    try:
        deadline = time.time() + 10.0
        while ref.swaps == 0 and time.time() < deadline:
            time.sleep(0.01)
        r = eng.decode(_queries(11, 1)[0])
        assert r.ok and r.index_version == 1
        np.testing.assert_array_equal(r.ids,
                                      _ref_ids(idx1, _queries(11, 1))[0])
        assert eng.counters()["index_train_step"] == 5
    finally:
        ref.stop()
        eng.stop()
    assert ref.swaps == 1 and not ref.is_alive()


def test_latency_histogram_matches_reference():
    """Same samples, same readout as the JAX package's histogram."""
    xs = np.random.default_rng(0).uniform(1.0, 100.0, 2000)
    mine, theirs = (LatencyHistogram(lo_ms=0.01, hi_ms=1000.0, growth=1.1),
                    JLatencyHistogram(lo_ms=0.01, hi_ms=1000.0, growth=1.1))
    for x in xs:
        mine.record(float(x))
        theirs.record(float(x))
    assert mine.snapshot() == theirs.snapshot()
    snap = mine.snapshot()
    assert abs(snap["p50"] - np.percentile(xs, 50)) / np.percentile(xs, 50) \
        < 0.15


def test_rejects_bad_query_dim_bad_buckets_and_missing_device(monkeypatch):
    w = _table(0)
    eng = _engine(w)
    with pytest.raises(ValueError, match="d_model"):
        eng.submit(np.zeros(D + 1, np.float32))
    with pytest.raises(ValueError, match="buckets"):
        _engine(w, buckets=(4, 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(_decode_fn(w), D, K)


def test_warmup_failure_raises_from_start():
    """Warm-up runs on the worker thread; its failure surfaces in start()
    and leaves no worker running."""
    def broken(index, h):
        raise ValueError("decode is broken")

    eng = ServingEngine(broken, D, K, device="cpu")
    with pytest.raises(RuntimeError, match="warm-up") as info:
        eng.start()
    assert isinstance(info.value.__cause__, ValueError)
    assert eng._thread is None
