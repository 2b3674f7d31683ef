"""Async serving engine: continuous batching, zero-downtime index refresh,
hot-query cache, SLO observability — port of ``repro.serve.server``
(DESIGN.md §5.1).

  * **continuous batching** — queries land in a queue that a worker thread
    drains into pad/bucketed microbatches of a small fixed set of shapes
    (``buckets``).  A microbatch dispatches when its largest bucket fills
    OR the oldest queued request has waited ``max_wait_ms``.
  * **per-request deadlines** — a request whose deadline passes while it
    is still queued fails fast (``ok=False, error='deadline exceeded'``).
  * **double-buffered index** — the ``RetrievalIndex`` or
    ``QuantizedRetrievalIndex`` (or ``None`` for the dense head) lives
    behind one atomically swapped reference that the worker reads EXACTLY
    ONCE per microbatch: every request is served entirely by one index
    version.
  * **hot-query cache** — repeated (quantized) hidden states short-circuit
    decode; keys are scoped by index version, so a swap invalidates them.
  * **observability** — counters (queue depth, batch occupancy, cache hit
    rate, index swaps/staleness) and a log-bucketed latency histogram.

The engine takes ONE ``decode_fn(index, h_batch) -> (ids, logits)``
(``engine.make_decode_fn`` builds the standard one) and runs it eagerly on
``device``: the worker moves each padded numpy microbatch there and brings
ids and logits back to numpy.  Warm-up calls every bucket once, so the
first request pays no kernel build.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.serve.quantized_index import payload_bytes
from repro_torch.utils.misc import resolve_device

__all__ = [
    "ServeResult",
    "ServingEngine",
    "IndexRefresher",
    "LatencyHistogram",
    "payload_bytes",
]


# --- observability ----------------------------------------------------------


class LatencyHistogram:
    """Log-bucketed latency histogram with percentile readout.

    Bounded memory (one int per bucket) no matter how many requests are
    recorded — the production-counter shape, not a raw sample list.
    Buckets are geometric from ``lo_ms`` to ``hi_ms`` at ratio ``growth``
    (~5% relative error per readout); values outside clamp to the edge
    buckets.  ``percentile`` interpolates within the winning bucket.
    """

    def __init__(self, lo_ms: float = 0.01, hi_ms: float = 60_000.0,
                 growth: float = 1.1):
        nb = int(math.ceil(math.log(hi_ms / lo_ms) / math.log(growth))) + 1
        self.bounds = [lo_ms * growth ** i for i in range(nb)]  # upper edges
        self.counts = [0] * (nb + 1)  # +1: overflow bucket
        self.count = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0

    def record(self, ms: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, ms)] += 1
        self.count += 1
        self.sum_ms += ms
        self.max_ms = max(self.max_ms, ms)

    def percentile(self, p: float) -> float:
        """p in [0, 100] -> latency ms (upper bucket edge; 0.0 if empty)."""
        if self.count == 0:
            return 0.0
        target = p / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c > 0:
                return self.bounds[min(i, len(self.bounds) - 1)]
        return self.max_ms

    def snapshot(self) -> dict:
        mean = self.sum_ms / self.count if self.count else 0.0
        return {"count": self.count, "mean": mean, "max": self.max_ms,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


# --- request/result ---------------------------------------------------------


@dataclasses.dataclass
class ServeResult:
    """One request's answer.  ``ok=False`` => deadline expiry or engine
    shutdown; ``index_version`` is the version of the index snapshot that
    served the WHOLE request (cache hits report the version they were
    cached under, which by the version-scoped key IS the current one)."""

    ids: np.ndarray | None
    logits: np.ndarray | None
    ok: bool
    error: str | None
    index_version: int
    cached: bool
    latency_ms: float


class _Request:
    __slots__ = ("h", "deadline", "t_enq", "result", "_ev")

    def __init__(self, h: np.ndarray, deadline: float):
        self.h = h
        self.deadline = deadline
        self.t_enq = time.perf_counter()
        self.result: ServeResult | None = None
        self._ev = threading.Event()

    # the future half, handed back to the submitter
    def done(self) -> bool:
        return self._ev.is_set()

    def result_wait(self, timeout: float | None = None) -> ServeResult:
        if not self._ev.wait(timeout):
            raise TimeoutError("serve result not ready")
        assert self.result is not None
        return self.result

    def _finish(self, result: ServeResult) -> None:
        self.result = result
        self._ev.set()


# --- hot-query cache --------------------------------------------------------


class _HotCache:
    """LRU over (index_version, quantized-h) -> (ids, logits).

    NOT thread-safe on its own; the engine worker is the only writer and
    the engine lock guards reads.  Version-scoped keys make an index swap
    an implicit full invalidation (stale entries can never hit and are
    evicted by recency)."""

    def __init__(self, size: int, quant: float):
        self.size = size
        self.quant = quant
        self._d: OrderedDict[tuple, tuple] = OrderedDict()

    def key(self, version: int, h: np.ndarray) -> tuple:
        q = np.round(np.asarray(h, np.float64) / self.quant).astype(np.int64)
        return (version, q.tobytes())

    def get(self, key: tuple):
        hit = self._d.get(key)
        if hit is not None:
            self._d.move_to_end(key)
        return hit

    def put(self, key: tuple, value: tuple) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.size:
            self._d.popitem(last=False)


# --- the engine -------------------------------------------------------------


class ServingEngine:
    """Continuous-batching request engine over one decode function.

    Parameters
    ----------
    decode_fn: ``(index, h (B, d) tensor) -> (ids (B, k), logits (B, k))``
        tensors; the dense path's ``index=None`` and the retrieval path
        coexist.  ``engine.make_decode_fn`` builds the standard one.
    d_model: hidden-state width every request must match.
    k: returned candidates per request (informational; decode_fn owns it).
    buckets: ascending microbatch shapes to pad into — the complete set of
        decode shapes that will ever run.  Non-divisible arrivals pad
        up to the smallest fitting bucket (masked rows are dropped before
        results are returned).
    max_wait_ms: continuous-batching patience — a microbatch launches when
        its largest bucket fills or the OLDEST queued request has waited
        this long.
    default_deadline_ms: queueing deadline applied when ``submit`` gives
        none; expired requests fail fast and free their batch slot.
    cache_size / cache_quant: hot-query LRU entries (0 disables) and the
        hidden-state quantization step for its keys.
    index / index_version / index_train_step: the initial snapshot behind
        the double buffer (``index=None`` serves the dense path).
    device: where decode runs — the card unless ``"cpu"`` is given; no
        device and no CUDA raises.  The index and head must live there.
    """

    def __init__(self, decode_fn: Callable[[Any, Any], tuple],
                 d_model: int, k: int, *,
                 buckets: tuple[int, ...] = (1, 2, 4, 8),
                 max_wait_ms: float = 2.0,
                 default_deadline_ms: float = 1_000.0,
                 cache_size: int = 0, cache_quant: float = 1e-3,
                 index: Any = None, index_version: int = 0,
                 index_train_step: int = 0,
                 device: str | torch.device | None = None):
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"buckets must be ascending unique, got "
                             f"{buckets}")
        self.d_model = int(d_model)
        self.k = int(k)
        self.buckets = tuple(int(b) for b in buckets)
        self.max_wait_s = max_wait_ms / 1e3
        self.default_deadline_s = default_deadline_ms / 1e3
        self.device = resolve_device(device)
        self._decode = decode_fn
        self._cache = _HotCache(cache_size, cache_quant) if cache_size \
            else None

        self._lock = threading.Condition()
        self._queue: deque[_Request] = deque()
        self._running = False
        self._thread: threading.Thread | None = None
        # the double buffer: ONE reference, swapped atomically, read once
        # per microbatch.  (index, version, train_step_it_was_built_from)
        self._index_ref: tuple[Any, int, int] = (
            index, int(index_version), int(index_train_step))
        self._train_step = int(index_train_step)
        # gauge: serialized bytes of the CURRENT index snapshot (0 = dense);
        # the train->serve shipping cost an int8 index exists to shrink.
        self._index_payload_bytes = payload_bytes(index) if index is not \
            None else 0

        self._hist = LatencyHistogram()
        self._c = {
            "submitted": 0, "completed": 0, "expired": 0, "rejected": 0,
            "cache_hits": 0, "cache_misses": 0,
            "microbatches": 0, "batch_slots": 0, "batch_real": 0,
            "queue_depth_peak": 0, "index_swaps": 0,
        }

    # -- lifecycle -----------------------------------------------------------
    def start(self, warmup: bool = True) -> "ServingEngine":
        """Launch the worker and return once it serves.  With ``warmup`` the
        worker first runs every bucket shape once, on its own thread (whose
        per-thread CUDA library handles decode then uses), so the first real
        request pays no kernel build or first-call cost."""
        with self._lock:
            if self._running:
                return self
            self._running = True
        ready = threading.Event()
        failed: list[Exception] = []
        self._thread = threading.Thread(
            target=self._worker, args=(warmup, ready, failed), daemon=True,
            name="serving-engine")
        self._thread.start()
        ready.wait()
        if failed:
            self.stop()
            raise RuntimeError("serving engine warm-up failed") from failed[0]
        return self

    def stop(self) -> None:
        """Drain: in-queue requests are failed with 'engine stopped'."""
        with self._lock:
            self._running = False
            pending = list(self._queue)
            self._queue.clear()
            self._lock.notify_all()
        for r in pending:
            r._finish(ServeResult(None, None, False, "engine stopped", -1,
                                  False, _ms_since(r.t_enq)))
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- request side --------------------------------------------------------
    def submit(self, h: np.ndarray,
               deadline_ms: float | None = None) -> _Request:
        """Enqueue one query (h: (d,) hidden state); returns a future with
        ``.result_wait(timeout)``."""
        h = np.asarray(h, np.float32).reshape(-1)
        if h.shape[0] != self.d_model:
            raise ValueError(f"query dim {h.shape[0]} != engine d_model "
                             f"{self.d_model}")
        ddl_s = (deadline_ms / 1e3 if deadline_ms is not None
                 else self.default_deadline_s)
        req = _Request(h, time.perf_counter() + ddl_s)
        with self._lock:
            self._c["submitted"] += 1
            self._queue.append(req)
            self._c["queue_depth_peak"] = max(self._c["queue_depth_peak"],
                                              len(self._queue))
            self._lock.notify_all()
        return req

    def decode(self, h: np.ndarray, timeout: float = 60.0,
               deadline_ms: float | None = None) -> ServeResult:
        """Synchronous convenience: submit + wait."""
        return self.submit(h, deadline_ms).result_wait(timeout)

    # -- index side ----------------------------------------------------------
    def swap_index(self, index: Any, *, version: int | None = None,
                   train_step: int | None = None) -> int:
        """Publish a new index snapshot (or ``None`` for dense).  One
        atomic reference assignment: in-flight microbatches finish on the
        snapshot they read, the next microbatch reads this one.  Returns
        the published version."""
        pb = payload_bytes(index) if index is not None else 0
        with self._lock:
            _, old_v, old_step = self._index_ref
            v = int(version) if version is not None else old_v + 1
            step = int(train_step) if train_step is not None else old_step
            self._index_ref = (index, v, step)
            self._c["index_swaps"] += 1
            self._index_payload_bytes = pb
        return v

    def note_train_step(self, step: int) -> None:
        """Tell the engine how far training has advanced — the staleness
        counter is ``train_step - index_train_step`` (steps behind)."""
        with self._lock:
            self._train_step = int(step)

    # -- observability -------------------------------------------------------
    def counters(self) -> dict:
        with self._lock:
            c = dict(self._c)
            _, version, idx_step = self._index_ref
            depth = len(self._queue)
            train_step = self._train_step
            payload = self._index_payload_bytes
            lat = self._hist.snapshot()
        served = c["cache_hits"] + c["cache_misses"]
        c.update(
            queue_depth=depth,
            index_version=version,
            index_train_step=idx_step,
            train_step=train_step,
            index_staleness_steps=max(0, train_step - idx_step),
            index_payload_bytes=payload,
            batch_occupancy=(c["batch_real"] / c["batch_slots"]
                             if c["batch_slots"] else 0.0),
            cache_hit_rate=(c["cache_hits"] / served if served else 0.0),
            latency_ms=lat,
        )
        return c

    # -- worker --------------------------------------------------------------
    def _run(self, index: Any, h: np.ndarray
             ) -> tuple[np.ndarray, np.ndarray]:
        """One decode on ``self.device``: numpy in, numpy out (the copy back
        waits for the device)."""
        with torch.inference_mode():
            ids, logits = self._decode(index,
                                       torch.from_numpy(h).to(self.device))
            return ids.cpu().numpy(), logits.cpu().numpy()

    def _take_batch(self) -> list[_Request] | None:
        """Block until a microbatch is due; expire stale requests in place.
        Returns None on shutdown."""
        max_bucket = self.buckets[-1]
        with self._lock:
            while True:
                if not self._running:
                    return None
                now = time.perf_counter()
                # fail expired requests fast — they never occupy a slot
                while self._queue and self._queue[0].deadline <= now:
                    r = self._queue.popleft()
                    self._c["expired"] += 1
                    r._finish(ServeResult(
                        None, None, False, "deadline exceeded", -1, False,
                        _ms_since(r.t_enq)))
                if not self._queue:
                    self._lock.wait(0.05)
                    continue
                n = len(self._queue)
                oldest_wait = now - self._queue[0].t_enq
                if n >= max_bucket or oldest_wait >= self.max_wait_s:
                    take = [self._queue.popleft()
                            for _ in range(min(n, max_bucket))]
                    return take
                # sleep until the batch is due: bucket-fill notify, the
                # oldest request's patience, or its deadline — whichever
                # comes first (a straggler can't hold the bucket open).
                slack = min(self.max_wait_s - oldest_wait,
                            self._queue[0].deadline - now)
                self._lock.wait(max(slack, 1e-4))

    def _worker(self, warmup: bool, ready: threading.Event,
                failed: list[Exception]) -> None:
        try:
            if warmup:
                index, _, _ = self._index_ref
                for b in self.buckets:
                    self._run(index, np.zeros((b, self.d_model), np.float32))
        except Exception as e:  # noqa: BLE001 — start() re-raises it
            failed.append(e)
            return
        finally:
            ready.set()
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            # ONE index snapshot per microbatch — the atomicity contract.
            with self._lock:
                index, version, _ = self._index_ref

            misses: list[_Request] = []
            keys: list[tuple | None] = []
            for r in batch:
                if self._cache is not None:
                    key = self._cache.key(version, r.h)
                    hit = self._cache.get(key)
                    if hit is not None:
                        ms = _ms_since(r.t_enq)
                        with self._lock:
                            self._c["cache_hits"] += 1
                            self._c["completed"] += 1
                            self._hist.record(ms)
                        r._finish(ServeResult(hit[0], hit[1], True, None,
                                              version, True, ms))
                        continue
                    keys.append(key)
                else:
                    keys.append(None)
                misses.append(r)

            if not misses:
                continue
            bucket = next(b for b in self.buckets if b >= len(misses))
            h_pad = np.zeros((bucket, self.d_model), np.float32)
            for i, r in enumerate(misses):
                h_pad[i] = r.h
            ids, logits = self._run(index, h_pad)
            with self._lock:
                self._c["microbatches"] += 1
                self._c["batch_slots"] += bucket
                self._c["batch_real"] += len(misses)
                self._c["cache_misses"] += len(misses)
                self._c["completed"] += len(misses)
            for i, r in enumerate(misses):
                if self._cache is not None:
                    self._cache.put(keys[i], (ids[i], logits[i]))
                ms = _ms_since(r.t_enq)
                with self._lock:
                    self._hist.record(ms)
                r._finish(ServeResult(ids[i], logits[i], True, None,
                                      version, False, ms))


def _ms_since(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


# --- background refresh -----------------------------------------------------


class IndexRefresher(threading.Thread):
    """Double-buffer filler: polls ``source()`` for a fresh index and swaps
    it into the engine.  The REBUILD (checkpoint restore + hierarchy build,
    the expensive part) runs entirely on this thread; the engine only ever
    pays the O(1) reference swap — decode never blocks on a refresh.

    ``source() -> (index, train_step) | None`` — None means "nothing new";
    ``train/step.serving_index_source`` builds the standard checkpoint-
    driven one.  Source exceptions are stored on ``.error`` and stop the
    refresher (a broken refresher must not silently freeze staleness)."""

    def __init__(self, engine: ServingEngine, source: Callable[[], Any],
                 poll_s: float = 0.5):
        super().__init__(daemon=True, name="index-refresher")
        self.engine = engine
        self.source = source
        self.poll_s = poll_s
        self.swaps = 0
        self.error: BaseException | None = None
        # NOT named _stop: threading.Thread.join() calls its own private
        # _stop() internally, and an Event here would shadow it.
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.is_set():
            try:
                fresh = self.source()
            except BaseException as e:  # noqa: BLE001
                self.error = e
                return
            if fresh is not None:
                index, train_step = fresh
                self.engine.swap_index(index, train_step=train_step)
                self.swaps += 1
            self._halt.wait(self.poll_s)

    def stop(self, join: bool = True) -> None:
        self._halt.set()
        if join:
            self.join()
        if self.error is not None:
            raise RuntimeError("index refresher died") from self.error
