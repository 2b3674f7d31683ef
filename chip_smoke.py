#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero and prints no
result line):
  1. device  — the card's name and power limit (nvidia-smi).
  2. build   — nvcc builds every CUDA kernel of the path from
               src/repro_torch/kernels/csrc/ into build/repro_torch/.
  3. kernels — each kernel against its plain PyTorch version on the card,
               at the path's shapes, with kernel / plain / library times
               (CUDA events, median of 25 runs after warm-up).
  4. serving — youtube-dnn at full width (100,000 items, 128-wide head):
               random seeded weights, retrieval index build, and 96
               requests (watch history + user features -> the port's tower
               on the card -> h) through the ServingEngine (beam 256).
  5. exact   — full-beam decode (gram bound on levels 1-9 through
               block_scores) equals the dense top-k, ties aside; narrow-beam
               logits equal their dense logits.
  6. breakdown — host-clock times of one decode's stages per bucket.
Phases 4-5 are the main path: the kernel launch counters are zeroed just
before phase 4 and read just after phase 5, and every kernel must have run.
The line before the last is {"kernels": [...]} and the last is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import hierarchy  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.block_scores import block_scores  # noqa: E402
from repro_torch.kernels.leaf_scores import leaf_scores  # noqa: E402
from repro_torch.kernels.zstats import zstats  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serve import engine, retrieval  # noqa: E402
from repro_torch.serve.server import ServingEngine, payload_bytes  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the fp32
# rate outside the tensor cores (the kernels run fp32 FMAs).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
#: max |kernel - plain| allowed, as a fraction of max |plain|: both sum
#: 128-term fp32 products (r^2 = 16384 terms for block_scores) in
#: different orders.
RTOL = 1e-5
REPS = 25

REPLACES = {
    "zstats": "src/repro/kernels/zstats.py:31",
    "block_scores": "src/repro/kernels/block_scores.py:52",
    "leaf_scores": "src/repro/kernels/leaf_scores.py:56",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn) -> float:
    """Median device time of one call, CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rel = float(((got - want).abs() / (want.abs() + 1e-30)).max())
    log(f"  {name}: max_abs_err={err} max_rel_err={rel} "
        f"(tolerance {RTOL} x max|plain| = {RTOL * scale})")
    if err > RTOL * scale:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: {err} > {RTOL * scale}")
    return err


def phase_device() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return line


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} kernels in {time.perf_counter() - t0:.2f} s "
        f"-> {_build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_kernels(gen: torch.Generator) -> dict[str, dict]:
    dev = torch.device("cuda")
    out = {}

    # zstats at the index build's shape: 1024 leaves of 128 rows, r = 128.
    nb, b, r = 1024, 128, 128
    w = torch.randn((nb, b, r), generator=gen, device=dev)
    z = zstats(w)
    err = compare("zstats (1024, 128, 128)", z, ref.zstats_ref(w))
    # ragged edges: rows and width off the 32-wide tiles (r = 200 is
    # ptb-lstm's width)
    w2 = torch.randn((7, 50, 200), generator=gen, device=dev)
    err = max(err, compare("zstats (7, 50, 200)", zstats(w2),
                           ref.zstats_ref(w2)))
    wt = w.transpose(1, 2)
    # Z_b is symmetric, so the function needs only its r(r+1)/2 distinct
    # entries: 2 * nb * B * r(r+1)/2 flops (a SYRK, not a full GEMM).
    bms, by = bound_ms(4 * (nb * b * r + nb * r * r), nb * b * r * (r + 1))
    out["zstats"] = dict(
        max_abs_err=err, ms=time_ms(lambda: zstats(w)),
        plain_ms=time_ms(lambda: ref.zstats_ref(w)), bound_ms=bms,
        bound_by=by, library_ms=time_ms(lambda: torch.bmm(wt, w)))

    # block_scores against every dense level's Z (levels 1-9 of the 1024-leaf
    # tree: 2..512 nodes), alpha = 1 and cnt = 0 as the gram bound calls it.
    levels = [z]
    while levels[0].shape[0] > 2:
        levels.insert(0, levels[0][0::2] + levels[0][1::2])
    levels = levels[:-1]  # drop the leaf level: levels 1..9
    err = 0.0
    for t in (1, 16):
        h = torch.randn((t, r), generator=gen, device=dev)
        for zl in levels:
            cnt = torch.zeros(zl.shape[0], device=dev)
            err = max(err, compare(
                f"block_scores T={t} N={zl.shape[0]}",
                block_scores(h, zl, cnt, alpha=1.0),
                ref.block_scores_ref(h, zl, cnt, 1.0)))
    # ragged: two query tiles (T = 19), r = 200, counts and alpha = 100
    h2 = torch.randn((19, 200), generator=gen, device=dev)
    z2 = ref.zstats_ref(torch.randn((5, 40, 200), generator=gen, device=dev))
    c2 = torch.arange(1, 6, dtype=torch.float32, device=dev)
    err = max(err, compare("block_scores T=19 N=5 r=200",
                           block_scores(h2, z2, c2, alpha=100.0),
                           ref.block_scores_ref(h2, z2, c2, 100.0)))
    # h (T = 16) from the loop above; times and bound are summed over the 9
    # levels: one decode's worth of block_scores calls.
    cnts = [torch.zeros(zl.shape[0], device=dev) for zl in levels]
    t = h.shape[0]
    ms = plain = lib = n_bytes = flops = 0.0
    for zl, cnt in zip(levels, cnts):
        n = zl.shape[0]
        ms += time_ms(lambda: block_scores(h, zl, cnt, alpha=1.0))
        plain += time_ms(lambda: ref.block_scores_ref(h, zl, cnt, 1.0))
        lib += time_ms(lambda: torch.einsum("nij,ti,tj->tn", zl, h, h))
        n_bytes += 4 * (t * r + n * r * r + n + t * n)
        flops += 2 * t * n * (r * r + r)
    bms, by = bound_ms(n_bytes, flops)
    out["block_scores"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               bound_ms=bms, bound_by=by, library_ms=lib)

    # leaf_scores at the decode's shape (T 16 x beam 256 = G 4096 leaves of
    # 128 rows, r = 128), both modes, plus a ragged G and a width that
    # takes the scalar (non-float4) loop.
    g, b = 4096, 128
    hg = torch.randn((g, r), generator=gen, device=dev)
    rows = torch.randn((g, b, r), generator=gen, device=dev)
    err = compare("leaf_scores dot (4096, 128, 128)",
                  leaf_scores(hg, rows, square=False),
                  ref.leaf_dots_ref(hg, rows))
    err = max(err, compare("leaf_scores square (4096, 128, 128)",
                           leaf_scores(hg, rows, alpha=100.0),
                           ref.leaf_scores_ref(hg, rows, 100.0)))
    for gg, bb, rr in ((4093, 128, 128), (37, 50, 126)):
        h2 = torch.randn((gg, rr), generator=gen, device=dev)
        r2 = torch.randn((gg, bb, rr), generator=gen, device=dev)
        err = max(err, compare(f"leaf_scores dot ({gg}, {bb}, {rr})",
                               leaf_scores(h2, r2, square=False),
                               ref.leaf_dots_ref(h2, r2)))
        err = max(err, compare(f"leaf_scores square ({gg}, {bb}, {rr})",
                               leaf_scores(h2, r2, alpha=100.0),
                               ref.leaf_scores_ref(h2, r2, 100.0)))
    h3 = hg[:, :, None]
    bms, by = bound_ms(4 * (g * r + g * b * r + g * b), 2 * g * b * r)
    out["leaf_scores"] = dict(
        max_abs_err=err, ms=time_ms(lambda: leaf_scores(hg, rows,
                                                        square=False)),
        plain_ms=time_ms(lambda: ref.leaf_dots_ref(hg, rows)), bound_ms=bms,
        bound_by=by, library_ms=time_ms(lambda: torch.bmm(rows, h3)))
    for name, row in out.items():
        log(f"[kernels] {name}: kernel {row['ms']} ms, plain "
            f"{row['plain_ms']} ms, library {row['library_ms']} ms, bound "
            f"{row['bound_ms']} ms ({row['bound_by']})")
    del w, z, levels, rows, hg
    torch.cuda.empty_cache()
    return out


def tower_queries(model, cfg, rng: np.random.Generator, n: int
                  ) -> torch.Tensor:
    """n (history, user_feats) pairs through the tower on the card."""
    history = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (n, cfg.history_len)))
    feats = torch.from_numpy(rng.normal(
        size=(n, cfg.user_feature_dim)).astype(np.float32))
    with torch.no_grad():
        return model(history.cuda(), feats.cuda())


def phase_serving(cfg, model, head, index, rng: np.random.Generator
                  ) -> None:
    k, beam, n_req = 10, 256, 96
    eng = ServingEngine(engine.make_decode_fn(cfg, None, head, k, beam=beam),
                        api.hidden_width(cfg), k, buckets=(1, 4, 16),
                        max_wait_ms=2.0, default_deadline_ms=60_000.0,
                        index=index, device="cuda")
    t0 = time.perf_counter()
    eng.start()
    log(f"[serving] warm-up of buckets (1, 4, 16): "
        f"{time.perf_counter() - t0:.3f} s; launches "
        f"{kernels.launch_counts()}")
    history = rng.integers(0, cfg.vocab_size, (n_req, cfg.history_len))
    feats = rng.normal(size=(n_req, cfg.user_feature_dim)).astype(np.float32)
    futs, hs = [], []
    t0 = time.perf_counter()
    try:
        for i in range(n_req):
            with torch.no_grad():
                h = model(torch.from_numpy(history[i:i + 1]).cuda(),
                          torch.from_numpy(feats[i:i + 1]).cuda())
            h = h.cpu().numpy()[0]
            hs.append(h)
            futs.append(eng.submit(h))
        results = [f.result_wait(120.0) for f in futs]
        wall = time.perf_counter() - t0
        c = eng.counters()  # the burst alone
        # one request at a time: the latency of an unloaded engine
        solo = []
        for h in hs[:16]:
            r = eng.decode(h, timeout=120.0)
            if not r.ok:
                raise AssertionError(f"request failed: {r.error}")
            solo.append(r.latency_ms)
    finally:
        eng.stop()
    bad = [r.error for r in results if not r.ok]
    if bad:
        raise AssertionError(f"{len(bad)} requests failed: {bad[:3]}")
    # every served logit is the exact dot of its id's head row
    hq = torch.from_numpy(np.stack(hs)).cuda()
    ids = torch.from_numpy(np.stack([r.ids for r in results])).cuda().long()
    got = torch.from_numpy(np.stack([r.logits for r in results])).cuda()
    exact = torch.einsum("tkd,td->tk", head[ids], hq)
    if not torch.allclose(got, exact, rtol=1e-5, atol=1e-5):
        raise AssertionError("served logits differ from their exact dots")
    lat = c["latency_ms"]
    log(f"[serving] burst of {n_req} requests ok in {wall:.3f} s: QPS "
        f"{n_req / wall}, latency p50 {lat['p50']} ms p99 {lat['p99']} ms "
        f"mean {lat['mean']} ms, microbatches {c['microbatches']}, "
        f"batch_occupancy {c['batch_occupancy']}; launches "
        f"{kernels.launch_counts()}")
    log(f"[serving] then 16 requests one at a time: latency median "
        f"{statistics.median(solo)} ms, max {max(solo)} ms")


def phase_exact(cfg, model, head, index, rng: np.random.Generator) -> None:
    k = 10
    h = tower_queries(model, cfg, rng, 16)
    ids, logits = retrieval.decode_topk(index, h, k, None, gram_cap=512)
    dids, dlog = retrieval.dense_topk(head, h, k + 1, n_valid=cfg.vocab_size)
    torch.cuda.synchronize()
    if not torch.allclose(logits, dlog[:, :k], rtol=1e-5, atol=0.0):
        raise AssertionError("full-beam logits differ from the dense top-k")
    near = lambda a, b: abs(a - b) <= 1e-5 * abs(b)  # noqa: E731
    ids_c, dids_c, dlog_c = ids.cpu(), dids.cpu(), dlog.cpu().tolist()
    swaps = 0
    for t in range(h.shape[0]):
        for j in range(k):
            if ids_c[t, j] == dids_c[t, j]:
                continue
            lt = dlog_c[t]
            if not (near(lt[j], lt[j - 1]) if j else False) and \
                    not near(lt[j], lt[j + 1]):
                raise AssertionError(
                    f"full beam id {int(ids_c[t, j])} != dense "
                    f"{int(dids_c[t, j])} at query {t} rank {j} without a "
                    "tie")
            swaps += 1
    log(f"[exact] full beam (gram_cap 512): ids equal dense_topk on 16 "
        f"queries ({swaps} tie swaps); launches {kernels.launch_counts()}")

    ids, logits = retrieval.decode_topk(index, h, k, 256)
    exact = torch.einsum("tkd,td->tk", head[ids.long()], h)
    if not torch.allclose(logits, exact, rtol=1e-5, atol=1e-5):
        raise AssertionError("narrow-beam logits differ from dense logits")
    if not (logits[:, :-1] >= logits[:, 1:]).all():
        raise AssertionError("narrow-beam logits are not sorted")
    rec = retrieval.recall_at_k(index, head, h, k, 256)
    log(f"[exact] beam 256: logits exact and sorted; recall@10 {rec} "
        "(random head, not gated)")


def host_ms(fn) -> float:
    """Median host-clock time of one call ending in a device sync."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(9):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_breakdown(cfg, model, head, index, rng: np.random.Generator
                    ) -> None:
    """Where one decode's time goes, per microbatch bucket (beam 256):
    the whole decode, its beam descent, its exact leaf step (gather + leaf
    kernel + top-k) and the gather alone, beside the dense head."""
    k, beam = 10, 256
    stats = retrieval.index_stats(index)
    depth = stats.depth
    unpack = hierarchy.unpack_levels
    ball = (unpack(index.mu, depth), unpack(index.rad, depth))
    spec = (unpack(index.evecs, depth), unpack(index.evals, depth))
    for b in (1, 4, 16):
        h = tower_queries(model, cfg, rng, b)
        leaves = retrieval.beam_descent(stats, h, beam, ball=ball, spec=spec)
        row = dict(
            decode=host_ms(lambda: retrieval.decode_topk(index, h, k, beam)),
            rehydrate=host_ms(lambda: retrieval.index_stats(index)),
            descent=host_ms(lambda: retrieval.beam_descent(
                stats, h, beam, ball=ball, spec=spec)),
            leaf_topk=host_ms(lambda: retrieval.leaf_topk(stats, h, leaves,
                                                          k)),
            gather=host_ms(lambda: stats.wq[leaves]),
            dense=host_ms(lambda: retrieval.dense_topk(
                head, h, k, n_valid=cfg.vocab_size)))
        log(f"[breakdown] T={b} host ms (median of 9, synced): "
            + ", ".join(f"{name} {ms}" for name, ms in row.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_kernels(gen)

    cfg = get_config("youtube-dnn")
    rng = np.random.default_rng(0)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model = api.init_params(cfg, gen, device="cuda")
    head = api.head_table(model, cfg).detach()
    torch.cuda.synchronize()
    log(f"[serving] youtube-dnn: {cfg.vocab_size} items, head "
        f"{tuple(head.shape)}, init {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    index = retrieval.build_index(head)
    torch.cuda.synchronize()
    log(f"[serving] index build {time.perf_counter() - t0:.3f} s: leaf "
        f"{index.leaf_size}, {index.num_leaves_shard} leaves, payload_bytes "
        f"{payload_bytes(index)}; launches {kernels.launch_counts()}")
    phase_serving(cfg, model, head, index, rng)
    phase_exact(cfg, model, head, index, rng)
    counts = kernels.launch_counts()
    missing = [name for name, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    phase_breakdown(cfg, model, head, index, rng)

    line = [dict(name=name, route="cuda",
                 source=str(_build.source(name).relative_to(
                     Path(__file__).resolve().parent)),
                 replaces=REPLACES[name], launches=counts[name], **rows[name])
            for name in rows]
    log(json.dumps({"kernels": line}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
