#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU and
check them.

Run from the root of a checkout:  python3 chip_smoke.py [--fresh]

Phases (any failure raises; the script then exits non-zero and prints no
result line):
  1. device    — the card's name and power limit (nvidia-smi).
  2. build     — nvcc builds every CUDA source of both paths from
                 src/repro_torch/kernels/csrc/ into build/repro_torch/, one
                 nvcc per source, all started together.
  3. kernels   — each kernel against its plain PyTorch version on the card,
                 with kernel / plain / library device times per call
                 (torch.profiler's device activities over 25 calls after
                 warm-up) and the kernel's per-call time as a caller sees
                 it (CUDA events around 10 back-to-back calls, median of
                 25): at the serving path's shapes, then
                 at the training path's (zstats (391, 256, 128),
                 block_scores T = 256 x 391 blocks, leaf_scores square
                 (32768, 256, 128), fused_lse / fused_lse_bwd at T = 256,
                 K = 129 over a 100,000 x 128 head, both abs modes, plus
                 ragged shapes).
  4. serving   — youtube-dnn at full width (100,000 items, 128-wide head):
                 random seeded weights, retrieval index build, and 96
                 requests (watch history + user features -> the port's tower
                 on the card -> h) through the ServingEngine (beam 256).
  5. exact     — full-beam decode (gram bound on levels 1-9 through
                 block_scores) equals the dense top-k, ties aside; narrow-beam
                 logits equal their dense logits.
  6. training  — youtube-dnn at full width: 60 steps of fit (batch 256,
                 sync block-quadratic refresh every step, m = 128, abs-mode
                 eq. 2/3 loss through the fused head, clip + AdamW) over a
                 cycled pool of 8 batches, where the loss must fall;
                 full-softmax loss of a held-out batch before and after;
                 the fused head's kernels against its plain path on a real
                 step's inputs; the trained head exported as a retrieval
                 index that decodes 16 queries.
 6b. fresh     — only with --fresh: 60 steps over fresh batches with the
                 sampled loss and with the exact full softmax, reported,
                 not gated.
  7. breakdown — host-clock times of one training step's stages, a
                 torch.profiler trace of three training steps (device time
                 by kernel, device busy share: the union of the device
                 intervals over the host wall), and host-clock times of one
                 decode's stages per bucket.
Phases 4-5 and phase 6 are the two main paths: the kernel launch counters
are zeroed just before each and read just after; serving must launch
zstats, block_scores and leaf_scores, training all five kernels.
The line before the last is {"kernels": [...]} (training-shape numbers and
training launches; the serving ones beside them under serving_*) and the
last is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import blocks, estimators, hierarchy  # noqa: E402
from repro_torch.core.sampled_softmax import (  # noqa: E402
    full_softmax_loss,
    fused_plan,
)
from repro_torch.core.samplers import sampler_from_config  # noqa: E402
from repro_torch.data.pipeline import batch_iterator_for  # noqa: E402
from repro_torch.kernels import _build, fused_head, ops, ref  # noqa: E402
from repro_torch.kernels.block_scores import block_scores  # noqa: E402
from repro_torch.kernels.leaf_scores import leaf_scores  # noqa: E402
from repro_torch.kernels.zstats import zstats  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.optim.transform import apply_updates  # noqa: E402
from repro_torch.serve import engine, retrieval  # noqa: E402
from repro_torch.serve.server import ServingEngine, payload_bytes  # noqa: E402
from repro_torch.train import loop, step  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the fp32
# rate outside the tensor cores (the kernels run fp32 FMAs).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
#: max |kernel - plain| allowed, as a fraction of max |plain|: both sum
#: 128-term fp32 products (r^2 = 16384 terms for block_scores) in
#: different orders.
RTOL = 1e-5
REPS = 25
#: back-to-back calls per CUDA-event pair in ``event_ms``
EVENT_CALLS = 10

REPLACES = {
    "zstats": "src/repro/kernels/zstats.py:31",
    "block_scores": "src/repro/kernels/block_scores.py:52",
    "leaf_scores": "src/repro/kernels/leaf_scores.py:56",
    "fused_lse": "src/repro/kernels/fused_head.py:107",
    "fused_lse_bwd": "src/repro/kernels/fused_head.py:178",
}
#: kernels each main path must launch
SERVING_KERNELS = ("zstats", "block_scores", "leaf_scores")
TRAINING_KERNELS = tuple(REPLACES)
TRAIN_STEPS = 60
TRAIN_BATCH = 256
#: batches in the training phase's fixed pool, cycled for TRAIN_STEPS: at
#: 100,000 items most labels of 60 fresh batches are items no earlier
#: batch trained, and the sampled loss stays at ln(n) there (``--fresh``
#: sets it beside the exact full softmax), so the gate's falling loss is
#: shown on seen data
TRAIN_POOL = 8
#: the device of the training phases
DEV = torch.device("cuda")


def log(msg: str) -> None:
    print(msg, flush=True)


def device_events(prof) -> list:
    """The device-side activities of a torch.profiler trace: kernels,
    memsets and copies (the aten ops that launch them are host events)."""
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def busy_us(events) -> float:
    """Length of the union of the events' device intervals, in us."""
    total, end = 0.0, -math.inf
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def device_ms(fn) -> float:
    """Device time of one call: the card's busy time over REPS calls
    (torch.profiler, device activities only), divided by REPS.

    Every timed function launches the same activities on each call, so a
    trace whose activity count is not a multiple of REPS lost some (a
    short trace sometimes records none): it is taken again, up to three
    times."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        if events and len(events) % REPS == 0:
            break
        log(f"  trace {attempt + 1} recorded {len(events)} device "
            f"activities for {REPS} calls")
    if not events:
        raise AssertionError("torch.profiler recorded no device activity")
    return busy_us(events) / REPS / 1e3


def event_ms(fn) -> float:
    """Time per call as a caller sees it, host work included: CUDA events
    around EVENT_CALLS back-to-back calls, median of REPS, per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(EVENT_CALLS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / EVENT_CALLS)
    return statistics.median(times)


def times(kernel, plain, library=None) -> dict[str, float | None]:
    """A kernel row's times: device ms per call of the kernel, its plain
    version and the library call, and the kernel's per-call event time."""
    return dict(ms=device_ms(kernel), event_ms=event_ms(kernel),
                plain_ms=device_ms(plain),
                library_ms=None if library is None else device_ms(library))


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
    log(f"[build] {len(_build.SIGNATURES)} kernels from {len(logs)} "
        f"sources in {time.perf_counter() - t0:.2f} s -> {_build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_kernels(gen: torch.Generator) -> dict[str, dict]:
    """The three serving kernels at the serving path's shapes."""
    dev = DEV
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
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **times(lambda: zstats(w), lambda: ref.zstats_ref(w),
                lambda: torch.bmm(wt, w)))

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
    # h (T = 16) from the loop above; one call below runs all 9 levels, so
    # times and bound are one decode's worth of block_scores calls.
    cnts = [torch.zeros(zl.shape[0], device=dev) for zl in levels]
    t = h.shape[0]
    n_bytes = flops = 0.0
    for zl in levels:
        n = zl.shape[0]
        n_bytes += 4 * (t * r + n * r * r + n + t * n)
        flops += 2 * t * n * (r * r + r)
    bms, by = bound_ms(n_bytes, flops)

    def per_level(fn):
        return lambda: [fn(zl, cnt) for zl, cnt in zip(levels, cnts)]

    out["block_scores"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by, **times(
            per_level(lambda zl, c: block_scores(h, zl, c, alpha=1.0)),
            per_level(lambda zl, c: ref.block_scores_ref(h, zl, c, 1.0)),
            per_level(lambda zl, c: torch.einsum("nij,ti,tj->tn", zl, h,
                                                 h))))

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
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **times(lambda: leaf_scores(hg, rows, square=False),
                lambda: ref.leaf_dots_ref(hg, rows),
                lambda: torch.bmm(rows, h3)))
    log_rows("serving shapes", out)
    del w, z, levels, rows, hg
    torch.cuda.empty_cache()
    return out


def log_rows(tag: str, rows: dict[str, dict]) -> None:
    for name, row in rows.items():
        log(f"[kernels] {name} ({tag}): device ms per call: kernel "
            f"{row['ms']}, plain {row['plain_ms']}, library "
            f"{row['library_ms']}, bound {row['bound_ms']} "
            f"({row['bound_by']}); kernel call by CUDA events "
            f"{row['event_ms']} ms")


def head_inputs(gen: torch.Generator, t: int, k: int, n: int, d: int):
    """A fused-head call shaped like the training path's: slot 0 a label,
    slots 1.. negatives drawn with replacement, corrections ln(m q), hits
    on the label and every 7th token's last slot masked with MASK_CORR,
    ids repeated within a token (slot 5 = slot 1) and across tokens (token
    i's slot 2 = token i+1's label)."""
    dev = DEV
    w = 0.05 * torch.randn((n, d), generator=gen, device=dev)
    h = torch.randn((t, d), generator=gen, device=dev)
    ids = torch.randint(0, n, (t, k), generator=gen, device=dev,
                        dtype=torch.int32)
    if k > 5:
        ids[:, 5] = ids[:, 1]
    if k > 2 and t > 1:
        ids[:-1, 2] = ids[1:, 0]
    q = torch.rand((t, k), generator=gen, device=dev) * 2.0 / n + 1e-9
    corr = torch.log((k - 1) * q)
    corr[:, 0] = 0.0
    hit = torch.zeros_like(corr, dtype=torch.bool)
    hit[:, 1:] = ids[:, 1:] == ids[:, :1]
    hit[::7, -1] = True
    corr = torch.where(hit, ops.MASK_CORR, corr)
    biasg = 0.1 * torch.randn((t, k), generator=gen, device=dev)
    return w, h, ids, corr, biasg


def check_fused(tag: str, gen: torch.Generator, w, h, ids, corr, biasg,
                abs_mode: bool) -> tuple[float, float]:
    """fused_lse and fused_lse_bwd against the plain chunked path on the
    same inputs; the backward gets the plain lse and a per-token cotangent,
    so it is held on its own."""
    lse = fused_head.fused_lse(w, h, ids, corr, biasg, abs_mode=abs_mode)
    lse_p = ops._chunked_lse(w, h, ids, corr, biasg, abs_mode)
    e_fwd = compare(f"fused_lse {tag}", lse, lse_p)
    gbar = torch.randn(h.shape[0], generator=gen, device=h.device)
    got = fused_head.fused_lse_bwd(w, h, ids, corr, biasg, lse_p, gbar,
                                   abs_mode=abs_mode)
    want = ops._chunked_lse_bwd(w, h, ids, corr, biasg, lse_p, gbar,
                                abs_mode)
    e_bwd = max(compare(f"fused_lse_bwd {name} {tag}", a, b)
                for name, a, b in zip(("dw", "dh", "dcoef", "dcorr"), got,
                                      want))
    return e_fwd, e_bwd


def phase_kernels_training(gen: torch.Generator, cfg) -> dict[str, dict]:
    """All five kernels at the training path's shapes (youtube-dnn: 100,000
    items in 391 blocks of 256 (160 real rows in the last), r = d = 128,
    T = 256, m = 128, alpha = 100)."""
    dev = DEV
    out = {}
    n, r, bsz = cfg.vocab_size, api.hidden_width(cfg), cfg.sampler_block
    t, m, alpha = TRAIN_BATCH, cfg.m_negatives, cfg.sampler_alpha
    nb = -(-n // bsz)

    # zstats: the refresh's leaf Grams, padding rows zero
    head = 0.05 * torch.randn((n, r), generator=gen, device=dev)
    stats = blocks.build(head, bsz)
    w = stats.wq
    z = zstats(w)
    err = compare(f"zstats ({nb}, {bsz}, {r})", z, ref.zstats_ref(w))
    wt = w.transpose(1, 2)
    bms, by = bound_ms(4 * (nb * bsz * r + nb * r * r), nb * bsz * r * (r + 1))
    out["zstats"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **times(lambda: zstats(w), lambda: ref.zstats_ref(w),
                lambda: torch.bmm(wt, w)))

    # block_scores: the sampler's root step, real counts
    hq = torch.randn((t, r), generator=gen, device=dev)
    cnt = stats.cnt
    err = compare(f"block_scores T={t} N={nb} alpha={alpha}",
                  block_scores(hq, z, cnt, alpha=alpha),
                  ref.block_scores_ref(hq, z, cnt, alpha))
    bms, by = bound_ms(4 * (t * r + nb * r * r + nb + t * nb),
                       2 * t * nb * (r * r + r))
    out["block_scores"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **times(lambda: block_scores(hq, z, cnt, alpha=alpha),
                lambda: ref.block_scores_ref(hq, z, cnt, alpha),
                lambda: torch.einsum("nij,ti,tj->tn", z, hq, hq)))

    # leaf_scores square: the within-block step, one (B, r) block per draw
    g = t * m
    blk = torch.randint(0, nb, (g,), generator=gen, device=dev)
    rows = w[blk]
    hg = hq.repeat_interleave(m, dim=0)
    err = compare(f"leaf_scores square ({g}, {bsz}, {r})",
                  leaf_scores(hg, rows, alpha=alpha),
                  ref.leaf_scores_ref(hg, rows, alpha))
    h3 = hg[:, :, None]
    bms, by = bound_ms(4 * (g * r + g * bsz * r + g * bsz),
                       g * bsz * (2 * r + 2))
    out["leaf_scores"] = dict(
        max_abs_err=err, bound_ms=bms, bound_by=by,
        **times(lambda: leaf_scores(hg, rows, alpha=alpha),
                lambda: ref.leaf_scores_ref(hg, rows, alpha),
                lambda: torch.bmm(rows, h3)))
    del rows, hg, h3, stats, w, wt, z
    torch.cuda.empty_cache()

    # fused_lse / fused_lse_bwd: the loss and its VJP
    k = 1 + m
    w, h, ids, corr, biasg = head_inputs(gen, t, k, n, r)
    e_fwd = e_bwd = 0.0
    for abs_mode in (True, False):
        ef, eb = check_fused(f"T={t} K={k} n={n} d={r} abs={abs_mode}", gen,
                             w, h, ids, corr, biasg, abs_mode)
        e_fwd, e_bwd = max(e_fwd, ef), max(e_bwd, eb)
    for tt, kk, nn, dd in ((37, 17, 1000, 200), (37, 17, 1000, 126)):
        args = head_inputs(gen, tt, kk, nn, dd)
        ef, eb = check_fused(f"T={tt} K={kk} n={nn} d={dd} abs=True", gen,
                             *args, True)
        e_fwd, e_bwd = max(e_fwd, ef), max(e_bwd, eb)
    uniq = int(torch.unique(ids).numel())  # rows this call's ids need
    lse = ops._chunked_lse(w, h, ids, corr, biasg, True)
    gbar = torch.full((t,), 1.0 / t, device=dev)
    tk = t * k
    bms, by = bound_ms(4 * (uniq * r + t * r + 3 * tk + t), 2 * tk * r)
    out["fused_lse"] = dict(
        max_abs_err=e_fwd, bound_ms=bms, bound_by=by,
        **times(lambda: fused_head.fused_lse(w, h, ids, corr, biasg,
                                             abs_mode=True),
                lambda: ops._chunked_lse(w, h, ids, corr, biasg, True)))
    bms, by = bound_ms(4 * (uniq * r + t * r + 3 * tk + 2 * t + n * r + t * r
                            + 2 * tk), 6 * tk * r)
    out["fused_lse_bwd"] = dict(
        max_abs_err=e_bwd, bound_ms=bms, bound_by=by,
        **times(lambda: fused_head.fused_lse_bwd(
                    w, h, ids, corr, biasg, lse, gbar, abs_mode=True),
                lambda: ops._chunked_lse_bwd(
                    w, h, ids, corr, biasg, lse, gbar, True)))
    log(f"[kernels] fused head: {uniq} distinct rows of {tk} slots")
    log_rows("training shapes", out)
    del w, h, ids, corr, biasg, lse, head
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


def eval_loss(state, cfg, batch) -> float:
    """Mean full-softmax (eq. 1, abs mode) loss of a batch: the dense head
    over all 100,000 items, no sampling."""
    with torch.no_grad():
        h, labels, _ = api.backbone_hidden(state.params, batch, cfg)
        return float(torch.mean(full_softmax_loss(
            api.head_table(state.params, cfg), h, labels,
            abs_mode=cfg.abs_softmax)))


def real_step_inputs(state, cfg, batch, gen):
    """The fused head's inputs of one training step, rebuilt from the
    trained state: tower -> h, refresh, sampled negatives, gather plan."""
    sampler = sampler_from_config(cfg)
    with torch.no_grad():
        h, labels, _ = api.backbone_hidden(state.params, batch, cfg)
        head = api.head_table(state.params, cfg).detach()
        sstate = step.make_refresh_fn(cfg)(head, state.sampler_state)
        runtime = sampler.hydrate(sstate, cfg.vocab_size)
        neg, logq = sampler.sample_batch(runtime, h, cfg.m_negatives, gen)
        ids, corr = fused_plan(labels, neg, logq)
    return head, h.contiguous(), ids.to(torch.int32), corr, neg, logq, \
        labels, runtime


def run_fit(cfg, data, tag: str):
    """60 steps of ``fit`` from seed 0; logs the loss means of the first and
    last 10 steps and returns them with the result."""
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    t0 = time.perf_counter()
    res = loop.fit(cfg, None, opt, data, TRAIN_STEPS, seed=0, log_every=10,
                   device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    first = statistics.mean(res.losses[:10])
    last = statistics.mean(res.losses[-10:])
    log(f"[training] {tag}: youtube-dnn {cfg.vocab_size} items, batch "
        f"{TRAIN_BATCH}, m {cfg.m_negatives}, {TRAIN_STEPS} steps in "
        f"{wall:.3f} s ({wall / TRAIN_STEPS * 1e3:.3f} ms/step, first step "
        f"included); sampled loss mean of steps 0-9 {first}, of steps "
        f"{TRAIN_STEPS - 10}-{TRAIN_STEPS - 1} {last}; stragglers "
        f"{res.straggler_steps}")
    return res, first, last


def held_out_batch(cfg) -> dict[str, torch.Tensor]:
    return next(batch_iterator_for(cfg, None, TRAIN_BATCH, 1, seed=1000,
                                   device=DEV))


def phase_training(cfg) -> tuple[dict[str, int], object]:
    """youtube-dnn at full width through fit: the training main path, on a
    cycled pool of TRAIN_POOL batches."""
    dev = DEV
    held = held_out_batch(cfg)
    # fit draws its state from seed 0 exactly as this does
    init = step.init_train_state(
        torch.Generator(dev).manual_seed(0), cfg, None,
        make_optimizer("adamw", 1e-2, weight_decay=0.0), device=dev)
    before = eval_loss(init, cfg, held)
    data = batch_iterator_for(cfg, None, TRAIN_BATCH, 1, seed=0, device=dev)
    pool = [next(data) for _ in range(TRAIN_POOL)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res, first, last = run_fit(cfg, itertools.cycle(pool),
                               f"pool of {TRAIN_POOL} batches")
    counts = kernels.launch_counts()
    log(f"[training] launches {counts}")
    missing = [k for k in TRAINING_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"training path never launched {missing}")
    if not all(math.isfinite(x) for x in res.losses) or not last < first:
        raise AssertionError(f"training loss did not fall: {first} -> "
                             f"{last}")
    log(f"[training] held-out full-softmax loss (batch {TRAIN_BATCH}): "
        f"before {before}, after the pool {eval_loss(res.state, cfg, held)}"
        f"; ln(n) = {math.log(cfg.vocab_size)}")

    # The fused head's kernels against its plain path on the inputs of the
    # first step fit takes (its initial state, a batch it has not seen).
    # (The pool run's overfit head makes the sampler send thousands of
    # draws to a few rows, so dL/dw sums thousands of terms per row and the
    # fp32 summation order alone uses half the tolerance.)
    gen = torch.Generator(dev).manual_seed(7)
    head, h, ids, corr, *_ = real_step_inputs(init, cfg, held, gen)
    biasg = torch.zeros(ids.shape, device=dev)
    masked = int((corr >= ops.MASK_CORR).sum())
    uniq = int(torch.unique(ids).numel())
    check_fused(f"real step ({masked} masked slots, {uniq} distinct ids)",
                gen, head, h, ids, corr, biasg, cfg.abs_softmax)
    del init, head, h, ids, corr

    # the trained head served: export the index and decode 16 queries
    t0 = time.perf_counter()
    index = step.export_retrieval_index(res.state, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    with torch.no_grad():
        hq, _, _ = api.backbone_hidden(
            res.state.params, {k: v[:16] for k, v in held.items()}, cfg)
    ids16, logits = retrieval.decode_topk(index, hq, 10, 256)
    w = api.head_table(res.state.params, cfg).detach()
    exact = torch.einsum("tkd,td->tk", w[ids16.long()], hq)
    if not torch.allclose(logits, exact, rtol=1e-5, atol=1e-5) or \
            not (logits[:, :-1] >= logits[:, 1:]).all():
        raise AssertionError("decode from the exported index is not exact "
                             "and sorted")
    rec = retrieval.recall_at_k(index, w, hq, 10, 256)
    log(f"[training] exported index in {build_s:.3f} s; 16 held-out "
        f"queries decoded at beam 256: logits exact and sorted, recall@10 "
        f"{rec}")
    return counts, res.state


def phase_fresh(cfg) -> None:
    """``--fresh``: TRAIN_STEPS steps over fresh batches (no pool), once
    with the configured sampled loss and once with the exact full softmax
    (estimator "full": no sampler, no fused head), each reported with the
    held-out full-softmax loss.  Not gated: it asks whether this depth
    learns anything on unseen labels, and whether sampling is what stops
    it."""
    held = held_out_batch(cfg)
    for est in (cfg.estimator, "full"):
        c = dataclasses.replace(cfg, estimator=est)
        res, _, _ = run_fit(c, batch_iterator_for(
            c, None, TRAIN_BATCH, 1, seed=500, device=DEV),
            f"fresh batches, estimator {est}")
        log(f"[fresh] estimator {est}: held-out full-softmax loss after "
            f"{TRAIN_STEPS} fresh steps {eval_loss(res.state, c, held)}; "
            f"ln(n) = {math.log(cfg.vocab_size)}")


def host_ms_split(setup, fn) -> float:
    """Median host-clock time of ``fn(setup())``, only ``fn`` timed."""
    times = []
    for i in range(10):
        arg = setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_training_breakdown(cfg, state) -> None:
    """Where one training step's time goes: host ms per stage, each ending
    in a device sync, median of 9, beside the whole step and the dense
    full-softmax head's forward + backward at the same T.  The sampler is
    timed whole (``sample_batch``), with its leaf step's block gather
    alone beside it; the profile phase splits its device time by kernel."""
    dev = DEV
    sampler = sampler_from_config(cfg)
    estimator = estimators.make_estimator(cfg.estimator)
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    data = batch_iterator_for(cfg, None, TRAIN_BATCH, 1, seed=2000,
                              device=dev)
    batch = next(data)
    gen = torch.Generator(dev).manual_seed(11)
    refresh = step.make_refresh_fn(cfg)
    head_p = api.head_table(state.params, cfg)
    head, h, ids, corr, neg, logq, labels, runtime = real_step_inputs(
        state, cfg, batch, gen)
    stats = runtime["stats"]
    m = cfg.m_negatives
    # the blocks of this step's draws: the leaf step's gather, timed alone
    blk = torch.div(neg.reshape(-1), stats.block_size, rounding_mode="floor")

    def forward(_=None):
        hh, lab, _ = api.backbone_hidden(state.params, batch, cfg)
        return torch.mean(estimators.loss_from_embeddings(
            estimator, head_p, hh, lab, neg, logq, abs_mode=cfg.abs_softmax,
            impl=cfg.head_impl))

    params = step.param_dict(state.params)
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    scratch = {k: p.detach().clone() for k, p in params.items()}

    def optimizer():
        upd, _ = opt.update(grads, state.opt_state, scratch)
        apply_updates(scratch, upd)

    def dense_setup():
        return head_p.detach().clone().requires_grad_(), h.detach()

    def dense(args):
        w_, h_ = args
        torch.mean(full_softmax_loss(w_, h_, labels,
                                     abs_mode=cfg.abs_softmax)).backward()

    train_step = step.make_train_step(cfg, None, opt)
    holder = {"state": state}

    def whole():
        holder["state"], _ = train_step(holder["state"], batch, gen)

    row = dict(
        refresh=host_ms(lambda: refresh(head_p, state.sampler_state)),
        sampler=host_ms(lambda: sampler.sample_batch(runtime, h, m, gen)),
        leaf_gather_of_sampler=host_ms(lambda: stats.wq[blk]),
        loss_forward=host_ms(forward),
        backward=host_ms_split(forward, lambda loss: loss.backward()),
        clip_adamw=host_ms(optimizer),
        step=host_ms(whole),
        dense_head_fwd_bwd=host_ms_split(dense_setup, dense))
    log(f"[breakdown] training step, T={TRAIN_BATCH}, m={m}: host ms "
        "(median of 9, synced): "
        + ", ".join(f"{name} {ms}" for name, ms in row.items()))
    log(f"[breakdown] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def phase_profile(cfg, state) -> None:
    """Device time by kernel over three training steps (torch.profiler,
    device activities only).  The busy time is the union of the device
    intervals; the host wall of the same three steps is taken once traced
    and once untraced, and the busy share is given against each."""
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    train_step = step.make_train_step(cfg, None, opt)
    data = batch_iterator_for(cfg, None, TRAIN_BATCH, 1, seed=3000,
                              device=DEV)
    batches = [next(data) for _ in range(3)]
    gen = torch.Generator(DEV).manual_seed(13)

    def three_steps(st):
        t0 = time.perf_counter()
        for b in batches:
            st, _ = train_step(st, b, gen)
        torch.cuda.synchronize()
        return st, (time.perf_counter() - t0) * 1e6

    state, _ = train_step(state, batches[0], gen)
    state, untraced_us = three_steps(state)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, wall_us = three_steps(state)
    events = device_events(prof)
    busy = busy_us(events)
    log(f"[profile] 3 training steps: device busy {busy:.0f} us (union of "
        f"{len(events)} device activities); host wall {wall_us:.0f} us "
        f"traced ({100 * busy / wall_us:.1f}% busy), {untraced_us:.0f} us "
        f"untraced ({100 * busy / untraced_us:.1f}%)")
    by_name: dict[str, list[float]] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    for name, durs in ranked[:15] + [kv for kv in ranked[15:]
                                     if "fused_lse" in kv[0]]:
        log(f"[profile]   {name[:70]}: {sum(durs):.0f} us over {len(durs)} "
            "calls")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fresh", action="store_true",
                    help="also train on fresh batches with the sampled and "
                         "the full-softmax loss (phase 6b)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    serving_rows = phase_kernels(gen)
    cfg = get_config("youtube-dnn")
    rows = phase_kernels_training(gen, cfg)

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
    serving_counts = kernels.launch_counts()
    missing = [k for k in SERVING_KERNELS if serving_counts[k] == 0]
    if missing:
        raise AssertionError(f"serving path never launched {missing}")

    counts, state = phase_training(cfg)
    if args.fresh:
        phase_fresh(cfg)
    phase_training_breakdown(cfg, state)
    phase_profile(cfg, state)
    phase_breakdown(cfg, model, head, index, rng)

    root = Path(__file__).resolve().parent
    line = []
    for name in TRAINING_KERNELS:
        entry = dict(name=name, route="cuda",
                     source=str(_build.source(name).relative_to(root)),
                     replaces=REPLACES[name], launches=counts[name],
                     **rows[name])
        if name in serving_rows:
            entry.update(serving_launches=serving_counts[name],
                         **{f"serving_{k}": v
                            for k, v in serving_rows[name].items()})
        line.append(entry)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": line}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
