"""The port's kernel layer (repro_torch.kernels) against the JAX package's.

On the CPU ``repro_torch.kernels.ops`` runs the plain PyTorch versions and
``repro.kernels.ops`` runs the Pallas kernels in interpret mode; both get the
same numpy inputs.  The CUDA kernels themselves run only on the card and are
held against these plain versions by ``chip_smoke.py``.  Tolerance: rtol
1e-5 (both sides sum fp32 products, in different orders), with an atol of
1e-5 where outputs pass through zero (raw dots).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels import ops, ref
from repro_torch.kernels.block_scores import block_scores
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.leaf_scores import leaf_scores
from repro_torch.kernels.midx_scores import (
    midx_member_scores,
    midx_pair_masses,
)
from repro_torch.kernels.rff_features import rff_features
from repro_torch.kernels.sampled_loss import sampled_loss
from repro_torch.kernels.zstats import zstats

torch.set_num_threads(1)


def _normal(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("nb,b,r", [(4, 32, 16), (7, 64, 8), (1, 128, 32),
                                    (3, 5, 7)])
def test_zstats_matches_jax(nb, b, r):
    w = _normal(nb, (nb, b, r))
    want = np.asarray(jops.zstats(jnp.asarray(w)))
    for got in (ops.zstats(torch.from_numpy(w)),
                ref.zstats_ref(torch.from_numpy(w))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(want, np.asarray(jref.zstats_ref(w)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("t,n,r", [(16, 8, 16), (100, 13, 8), (128, 4, 32),
                                   (1, 1, 8), (3, 9, 12)])
def test_block_scores_matches_jax(t, n, r):
    h = _normal(t, (t, r))
    z = np.array(jref.zstats_ref(_normal(n, (n, 32, r))))
    cnt = np.arange(n, dtype=np.float32) + 1
    want = np.asarray(jops.block_scores(jnp.asarray(h), jnp.asarray(z),
                                        jnp.asarray(cnt), alpha=100.0))
    th, tz, tc = map(torch.from_numpy, (h, z, cnt))
    for got in (ops.block_scores(th, tz, tc, alpha=100.0),
                ref.block_scores_ref(th, tz, tc, 100.0)):
        assert got.shape == (t, n)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("g,b,r", [(16, 8, 16), (100, 4, 8), (128, 32, 32),
                                   (1, 16, 8), (37, 8, 16)])
@pytest.mark.parametrize("mode", ["square", "dot"])
def test_leaf_scores_and_dots_match_jax(g, b, r, mode):
    h = _normal(g, (g, r))
    rows = _normal(b + 1000, (g, b, r))
    th, trows = torch.from_numpy(h), torch.from_numpy(rows)
    if mode == "square":
        want = np.asarray(jops.leaf_scores(jnp.asarray(h), jnp.asarray(rows),
                                           alpha=100.0))
        outs = (ops.leaf_scores(th, trows, alpha=100.0),
                ref.leaf_scores_ref(th, trows, 100.0))
    else:
        want = np.asarray(jops.leaf_dots(jnp.asarray(h), jnp.asarray(rows)))
        outs = (ops.leaf_dots(th, trows), ref.leaf_dots_ref(th, trows))
    for got in outs:
        assert got.shape == (g, b)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_ops_upcast_bf16_like_the_reference():
    """On the CPU the plain versions upcast bf16 inputs to fp32, as the
    Pallas bodies do; the CUDA wrappers take fp32 only (next test)."""
    w = torch.from_numpy(_normal(0, (2, 8, 4))).to(torch.bfloat16)
    got = ops.zstats(w)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               ref.zstats_ref(w.float()).numpy(), rtol=1e-6)


@pytest.mark.parametrize("call", [
    lambda: zstats(torch.zeros(2, 4, 4)),
    lambda: block_scores(torch.zeros(2, 4), torch.zeros(3, 4, 4),
                         torch.zeros(3)),
    lambda: leaf_scores(torch.zeros(2, 4), torch.zeros(2, 3, 4)),
    lambda: rff_features(torch.zeros(2, 3, 4), torch.zeros(5, 4),
                         torch.ones(2, 3), torch.zeros(())),
    lambda: midx_pair_masses(torch.zeros(2, 4), torch.zeros(3, 4),
                             torch.ones(3)),
    lambda: midx_member_scores(torch.zeros(2, 4), torch.zeros(2, 3, 4)),
    lambda: sampled_loss(torch.zeros(2, 4), torch.zeros(3, 4), torch.zeros(3),
                         torch.zeros(2), m_total=3),
    lambda: flash_attention(torch.zeros(1, 3, 2, 4), torch.zeros(1, 3, 1, 4),
                            torch.zeros(1, 3, 1, 4)),
], ids=["zstats", "block_scores", "leaf_scores", "rff_features",
        "midx_pair_masses", "midx_member_scores", "sampled_loss",
        "flash_attention"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches its CUDA kernel or raises: a CPU tensor is refused
    before anything is built, and no launch is counted."""
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()
    assert kernels.launch_counts() == {
        "zstats": 0, "block_scores": 0, "leaf_scores": 0, "fused_lse": 0,
        "fused_lse_bwd": 0, "rff_features": 0, "midx_pair_masses": 0,
        "midx_member_scores": 0, "sampled_loss": 0, "flash_attention": 0,
        "flash_attention_simt": 0, "flash_attention_bwd": 0,
        "flash_attention_bwd_simt": 0}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_check_refuses_non_cuda_devices(device):
    with pytest.raises(ValueError, match="CUDA"):
        _build.check("x", torch.empty(4, 4, device=device), 2)


def test_ops_refuse_mixed_devices():
    with pytest.raises(ValueError, match="devices"):
        ops.leaf_dots(torch.zeros(2, 4), torch.zeros(2, 3, 4, device="meta"))


def test_build_library_path_tracks_source_and_flags():
    """Libraries are cached by a hash of source + flags, one per source
    (the two fused-head kernels share one, as do the two midx kernels, the
    four flash forward entries and the two flash backward entries), in
    build/repro_torch/ (a directory .gitignore lists)."""
    paths = {name: _build.library_path(name) for name in _build.SIGNATURES}
    assert len(set(paths.values())) == 9
    assert paths["fused_lse"] == paths["fused_lse_bwd"]
    assert paths["midx_pair_masses"] == paths["midx_member_scores"]
    assert paths["flash_attention"] == paths["flash_attention_simt"] == \
        paths["flash_attention_lse"] == paths["flash_attention_simt_lse"]
    assert paths["flash_attention_bwd"] == paths["flash_attention_bwd_simt"]
    assert paths["flash_attention_bwd"] != paths["flash_attention"]
    for name, p in paths.items():
        src = _build.source(name)
        assert p.parent == _build.BUILD_DIR
        assert p.name.startswith(src.stem + "-") and p.suffix == ".so"
        assert src.is_file() and src.parent.name == "csrc"
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")


def test_build_library_path_tracks_shared_headers(tmp_path, monkeypatch):
    """A source that includes a shared header (``csrc/*.cuh``) rebuilds when
    the header changes: the cache hash covers the headers too."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    before = {name: _build.library_path(name) for name in _build.SIGNATURES}
    header = csrc / "row_dots.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.SIGNATURES}
    for name in ("leaf_scores", "midx_member_scores"):
        assert after[name] != before[name]
        assert after[name].name.startswith(_build.source(name).stem + "-")


def _capture_launches(monkeypatch) -> list:
    """Stand in for the card: the wrappers' launches are recorded, not
    made (their checks pass CPU tensors, the stream is 7)."""
    import types

    calls = []
    monkeypatch.setattr(_build, "check", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=7))
    kernels.reset_launch_counts()
    return calls


@pytest.mark.parametrize("r", [3625, 4096])
def test_block_scores_launches_at_any_width(r, monkeypatch):
    """The kernel tiles Z_n as ``block_scores.plan`` says, so a width past
    the 3,624 whose whole 16-query tile once had to fill a block's shared
    memory (llama3-8b's r = 4096 among them) launches like any other: one
    call of the entry point (its tile and combine kernels both behind it),
    with (T, N, r, alpha) as given, the plan's tiling, a workspace for the
    tiles' partials, and counted once."""
    from repro_torch.kernels.block_scores import plan

    calls = _capture_launches(monkeypatch)
    out = block_scores(torch.zeros(3, r), torch.zeros(2, r, r),
                       torch.zeros(2), alpha=2.5)
    assert out.shape == (3, 2) and out.dtype == torch.float32
    assert len(calls) == 1
    name, *ptrs, t, n, width, alpha, tq, bj, m, bi, _, stream = calls[0]
    assert name == "block_scores" and len(ptrs) == 5
    assert (t, n, width, alpha, stream) == (3, 2, r, 2.5, 7)
    p = plan(3, 2, r)
    assert (tq, bj, m, bi) == (p.tq, p.bj, p.m, p.bi) and p.n_i * p.n_j > 1
    assert kernels.launch_counts()["block_scores"] == 1


@pytest.mark.parametrize("g,b,r", [(128, 4096, 4096), (32768, 256, 128),
                                   (4096, 128, 128), (3, 4097, 4096),
                                   (5, 300, 4094)])
@pytest.mark.parametrize("name", ["leaf_scores", "midx_member_scores"])
def test_row_dots_launch_with_the_plan(name, g, b, r, monkeypatch):
    """leaf_scores and midx_member_scores launch once per call with (G, B,
    r) as given and ``leaf_scores.plan``'s chunk and unroll (tensors are
    empty-strided stand-ins: nothing is read)."""
    from repro_torch.kernels.leaf_scores import plan

    calls = _capture_launches(monkeypatch)
    h = torch.zeros(g, r)
    rows = torch.zeros(1).expand(g, b, r)
    if name == "leaf_scores":
        out = leaf_scores(h, rows, alpha=2.5, square=False)
    else:
        out = midx_member_scores(h, rows, alpha=2.5)
    assert out.shape == (g, b) and len(calls) == 1
    got, *ptrs, gg, bb, rr, alpha = calls[0][:8]
    chunk, unroll, _, stream = calls[0][-4:]
    assert got == name and len(ptrs) == 3
    assert (gg, bb, rr, alpha, stream) == (g, b, r, 2.5, 7)
    p = plan(g, b, r)
    assert (chunk, unroll) == (p.chunk, p.unroll)
    assert kernels.launch_counts()[name] == 1


#: sampled_loss's shapes in chip_smoke.py, with the route and the split
#: its plan must take: (T, m, d, dtype, route, split)
SAMPLED_LOSS_SHAPES = [
    (1024, 512, 128, torch.float32, "simt", True),
    (256, 128, 128, torch.float32, "simt", True),
    (2176, 512, 4096, torch.bfloat16, "mma", True),
    (1000, 500, 128, torch.float32, "simt", True),
    (1000, 500, 4096, torch.bfloat16, "mma", True),
    (1024, 512, 128, torch.bfloat16, "mma", True),
    (300, 200, 136, torch.bfloat16, "mma", True),
    (300, 200, 126, torch.bfloat16, "simt", True),
    (100, 150, 136, torch.bfloat16, "mma", False),
    (100, 150, 126, torch.bfloat16, "simt", False),
    (100, 150, 128, torch.float32, "simt", False),
]


@pytest.mark.parametrize("t,m,d,dtype,route,split", SAMPLED_LOSS_SHAPES)
def test_sampled_loss_launches_with_the_plan(t, m, d, dtype, route, split,
                                             monkeypatch):
    """sampled_loss launches once per call, counted once, with (T, m, d)
    as given and ``sampled_loss.plan``'s route, tiling and m-splits, and a
    (2, splits, T) fp32 workspace exactly where m is split (tensors are
    empty-strided stand-ins: nothing is read)."""
    from repro_torch.kernels.sampled_loss import TILINGS, plan

    calls = _capture_launches(monkeypatch)
    h = torch.zeros(1, dtype=dtype).expand(t, d)
    w = torch.zeros(1, dtype=dtype).expand(m, d)
    out = sampled_loss(h, w, torch.zeros(m), torch.zeros(t), m_total=2048)
    assert out.shape == (t,) and out.dtype == torch.float32
    assert len(calls) == 1
    name, *ptrs, tt, mm, dd, log_m, bf16, mma, bt, bn, e1, e2, splits, _, \
        stream = calls[0]
    assert name == "sampled_loss" and len(ptrs) == 6
    assert (tt, mm, dd, stream) == (t, m, d, 7)
    assert log_m == pytest.approx(math.log(2048))
    assert bf16 == int(dtype == torch.bfloat16)
    p = plan(t, m, d, dtype)
    assert p.route == route and mma == int(route == "mma")
    assert (bt, bn, e1, e2) == (p.bt, p.bn, p.e1, p.e2)
    assert (bt, bn, e1, e2) in TILINGS[route]
    assert splits == p.splits and (splits > 1) == split
    assert p.n_tt == -(-t // bt) and p.per_split * (splits - 1) < -(-m // bn)
    assert p.workspace == ((2, splits, t) if split else (0,))
    assert (ptrs[5] != 0) == split  # the workspace, where m is split
    assert kernels.launch_counts()["sampled_loss"] == 1


def test_sampled_loss_entry_shape_takes_one_wave_of_80_token_tiles():
    """At llama3-8b's entry run (T 2,176 = 17 x 128) 64- and 128-token
    tiles leave blocks over whole waves of 132; the plan takes 80 x 128
    tiles, 28 x 4 = 112 blocks."""
    from repro_torch.kernels.sampled_loss import SLOTS, plan

    p = plan(2176, 512, 4096, torch.bfloat16)
    assert (p.bt, p.bn, p.n_tt, p.splits) == (80, 128, 28, 4)
    assert p.n_tt * p.splits <= SLOTS["mma"]
    assert p.workspace == (2, 4, 2176)


@pytest.mark.parametrize("dtype,d,aligned,route", [
    (torch.bfloat16, 4096, True, "mma"), (torch.bfloat16, 136, True, "mma"),
    (torch.bfloat16, 4096, False, "simt"), (torch.bfloat16, 126, True, "simt"),
    (torch.float32, 128, True, "simt"), (torch.float32, 4096, True, "simt")])
def test_sampled_loss_route_follows_dtype_width_and_alignment(dtype, d,
                                                              aligned, route):
    from repro_torch.kernels.sampled_loss import plan

    assert plan(512, 256, d, dtype, aligned).route == route


def test_sampled_loss_takes_an_unaligned_bf16_h_on_the_cuda_cores(
        monkeypatch):
    """A bf16 h one element past a 16-byte boundary goes to the CUDA-core
    route (the TMA needs 16-byte aligned rows)."""
    calls = _capture_launches(monkeypatch)
    h = torch.zeros(300 * 136 + 1, dtype=torch.bfloat16)[1:].view(300, 136)
    w = torch.zeros(200, 136, dtype=torch.bfloat16)
    sampled_loss(h, w, torch.zeros(200), torch.zeros(300), m_total=200)
    assert calls[0][11] == 1 and calls[0][12] == 0  # bf16, not mma


def test_sampled_loss_mixed_dtypes_go_through_ops_as_fp32(monkeypatch):
    """ops.sampled_loss takes h and w_neg of different dtypes as fp32: one
    launch on the CUDA-core route."""
    calls = _capture_launches(monkeypatch)
    monkeypatch.setattr(ops, "_on_cuda", lambda *ts: True)
    ops.sampled_loss(torch.zeros(1024, 128, dtype=torch.bfloat16),
                     torch.zeros(512, 128), torch.zeros(512),
                     torch.zeros(1024))
    assert len(calls) == 1 and calls[0][11:13] == (0, 0)  # fp32, simt
    assert kernels.launch_counts()["sampled_loss"] == 1


@pytest.mark.parametrize("n_leaves,b,d,n_feat,tau", [(512, 256, 128, 128, 1.0),
                                                     (37, 50, 126, 100, 0.7)])
def test_rff_features_launch_arguments(n_leaves, b, d, n_feat, tau,
                                       monkeypatch):
    """rff_features launches once per call with (L, B, d, D) as given and
    1 / sqrt(tau), 1 / (2 tau) and D^{-1/2}; counted once."""
    calls = _capture_launches(monkeypatch)
    out = rff_features(torch.zeros(1).expand(n_leaves, b, d),
                       torch.zeros(1).expand(n_feat, d),
                       torch.zeros(1).expand(n_leaves, b), torch.zeros(1),
                       tau=tau)
    assert out.shape == (n_leaves, n_feat) and len(calls) == 1
    name, *ptrs, ll, bb, dd, ff, inv_sqrt_tau, inv_2tau, inv_sqrt_d, _, \
        stream = calls[0]
    assert name == "rff_features" and len(ptrs) == 5
    assert (ll, bb, dd, ff, stream) == (n_leaves, b, d, n_feat, 7)
    assert inv_sqrt_tau == pytest.approx(tau ** -0.5)
    assert inv_2tau == pytest.approx(0.5 / tau)
    assert inv_sqrt_d == pytest.approx(n_feat ** -0.5)
    assert kernels.launch_counts()["rff_features"] == 1
