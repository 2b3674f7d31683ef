"""The tensor-core attention backward's decomposition, on the CPU.

``flash_attention.plan`` cuts each key tile's (query head, query step)
sweep of the dK/dV kernel into shares; the kernel decodes its block index
into (key tile, batch and KV head, share) and the last share of a tile to
end folds the fp32 partials in share order.  Here the plan is checked at
every shape ``chip_smoke.py`` runs the tensor-core route at (each (batch,
query head, key tile, query step) covered once, the grid within the card's
limits, the fold's slots contiguous and in share order), and the kernels'
decomposition is replayed in plain fp32 PyTorch (the dQ kernel's two
sweeps over 64-key tiles, D = rowsum(P o dP) from the first; the dK/dV
kernel's shares and fold) against ``jax.grad`` of the reference's
``chunked_attention`` and against autograd through the plain version with
``s_valid``, within 1e-5 x max (fp32 summation order).  The CUDA kernels
themselves are held against the plain version on the card by
``chip_smoke.py``.  The D route is held to the precision the backward
needs: rowsum(P o dP) from fp32 P and dP keeps dQ within 1e-6 of the exact
chain rule, where the forward's bf16 output plus its bf16 remainder (a
route that would drop the first sweep) does not.
"""
import dataclasses
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch import kernels
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

#: (b, s, h, kv, hd, causal) of every tensor-core backward call in
#: chip_smoke.py's phases 18a and 18 (starcoder2-3b's training shape,
#: ragged S, llama3-8b's, s_valid cases, MHA, the width sweep, the autograd
#: check)
CHIP_SHAPES = [(4, 1024, 24, 2, 128, True), (4, 1000, 24, 2, 128, True),
               (2, 512, 8, 2, 128, False), (2, 512, 8, 2, 128, True),
               (1, 300, 4, 2, 64, True), (4, 512, 8, 8, 128, True),
               (2, 300, 24, 2, 128, True), (1, 2048, 32, 8, 128, True),
               (1, 200, 8, 2, 96, True), (2, 256, 8, 2, 32, False)] + [
                   (1, 200, 4, 2, w, True) for w in (16, 32, 48, 80, 112)]


def _blocks(p: fa.Plan, b: int, kv: int):
    """The dK/dV grid as the kernel decodes it: block index -> (key tile,
    b * KV + KV head, share, first and end step)."""
    out = []
    for kt, ns in enumerate(p.splits):
        for bkv in range(b * kv):
            for j, (t0, t1) in enumerate(p.shares(kt)):
                out.append((kt, bkv, j, t0, t1))
    # the kernel: key tile by key tile, each (b, KV head)'s shares together
    return out


@pytest.mark.parametrize("b,s,h,kv,hd,causal", CHIP_SHAPES)
def test_plan_covers_every_step_once(b, s, h, kv, hd, causal):
    p = fa.plan(b, s, h, kv, hd, causal)
    group, n_qt = h // kv, -(-s // fa.QUERY_STEP)
    n_kt = -(-s // fa.KEY_TILE)
    assert len(p.steps) == len(p.splits) == n_kt
    blocks = _blocks(p, b, kv)
    assert len(blocks) == p.blocks == b * kv * sum(p.splits)
    assert p.blocks < 2 ** 31 - 1 and p.dq_blocks < 2 ** 31 - 1
    assert p.dq_blocks == b * h * -(-s // fa.DQ_QUERY_TILE)
    assert 1 <= p.chunk and p.counters == b * kv * n_kt
    seen = set()
    for slot, (kt, bkv, j, t0, t1) in enumerate(blocks):
        assert 1 <= t1 - t0 <= p.chunk
        qt_first = kt * fa.KEY_TILE // fa.QUERY_STEP if causal else 0
        per_head = n_qt - qt_first
        for t in range(t0, t1):
            cell = (bkv // kv, (bkv % kv) * group + t // per_head, kt,
                    qt_first + t % per_head)
            assert cell not in seen
            seen.add(cell)
        # the fold reads the tile's shares from contiguous slots, in order
        assert blocks[slot - j][:3] == (kt, bkv, 0)
    want = {(bb, hh, kt, qt) for bb in range(b) for hh in range(h)
            for kt in range(n_kt) for qt in range(n_qt)
            if not causal or qt >= kt * fa.KEY_TILE // fa.QUERY_STEP}
    assert seen == want
    split = max(p.splits) > 1
    assert p.workspace_floats == (p.blocks * 2 * 64 * fa._hd_p(hd) * 2
                                  if split else 0)
    assert p.fold_bytes == 2 * 4 * (2 * 64 * fa._hd_p(hd) * 2) * b * kv * sum(
        ns for ns in p.splits if ns > 1)


def test_plan_fills_the_card_at_the_training_shape():
    """starcoder2-3b's training shape: the group is split and the grid is
    two waves of near-equal blocks (the dK/dV kernel it replaces ran one
    wave of 128 blocks with the causal work spread 16:1); a group of one
    at (4, 512, 8 / 8) already fills one wave and is not split."""
    p = fa.plan(4, 1024, 24, 2, 128, True)
    assert max(p.splits) > 1 and p.blocks > fa.H100_SMS and p.waves >= 2
    sizes = [t1 - t0 for kt in range(len(p.steps)) for t0, t1 in p.shares(kt)]
    assert max(sizes) <= p.chunk and min(sizes) >= p.chunk // 2
    assert max(fa.plan(4, 512, 8, 8, 128, True).splits) == 1


def _replay(q, k, v, dout, causal, s_valid=None, chunk=None):
    """The tensor-core backward's decomposition in fp32: the dQ kernel's
    blocks of 128 queries (two warpgroups of 64) sweeping 64-key tiles
    twice (D = rowsum(P o dP), then dS and dQ), and the dK/dV kernel's
    blocks of 128 keys sweeping their share of (query head, 64-query
    step)s, folded in share order.  ``chunk`` overrides the plan's."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    group = h // kv
    scale = 1.0 / math.sqrt(hd)
    kv_lim = s if s_valid is None else min(s, s_valid)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    _, lse = ref.flash_attention_ref(q, k, v, causal=causal, s_valid=s_valid,
                                     with_lse=True)

    def probs(bb, hh, qs, ks):
        """P (len(qs), len(ks)) of head hh, masked."""
        sc = qf[bb, qs, hh] @ kf[bb, ks, hh // group].T * scale
        p = torch.exp(sc - lse[bb, hh, qs][:, None])
        keep = (ks[None, :] < kv_lim) & (qs[:, None] < s)
        if causal:
            keep &= ks[None, :] <= qs[:, None]
        return torch.where(keep, p, 0.0)

    dq = torch.zeros_like(qf)
    delta = torch.zeros(b, h, s)
    for bb in range(b):
        for hh in range(h):
            for q0 in range(0, s, fa.DQ_QUERY_TILE):
                kv_end = min(kv_lim, q0 + fa.DQ_QUERY_TILE) if causal \
                    else kv_lim
                for w0 in range(q0, min(q0 + fa.DQ_QUERY_TILE, s), 64):
                    qs = torch.arange(w0, min(w0 + 64, s))
                    d = torch.zeros(len(qs))
                    tiles = [torch.arange(k0, min(k0 + 64, s))
                             for k0 in range(0, kv_end, 64)]
                    for ks in tiles:  # first sweep: D
                        dp = dof[bb, qs, hh] @ vf[bb, ks, hh // group].T
                        d += (probs(bb, hh, qs, ks) * dp).sum(1)
                    delta[bb, hh, qs] = d
                    acc = torch.zeros(len(qs), hd)
                    for ks in tiles:  # second sweep: dQ
                        dp = dof[bb, qs, hh] @ vf[bb, ks, hh // group].T
                        ds = probs(bb, hh, qs, ks) * (dp - d[:, None])
                        acc += ds @ kf[bb, ks, hh // group]
                    dq[bb, qs, hh] = acc * scale
    p = fa.plan(b, s, h, kv, hd, causal)
    if chunk is not None:
        p = dataclasses.replace(p, chunk=chunk, splits=tuple(
            max(1, -(-n // chunk)) for n in p.steps))
    n_qt = -(-s // fa.QUERY_STEP)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for kt in range(len(p.steps)):
        k0 = kt * fa.KEY_TILE
        ks = torch.arange(k0, min(k0 + fa.KEY_TILE, s))
        qt_first = kt * fa.KEY_TILE // fa.QUERY_STEP if causal else 0
        per_head = n_qt - qt_first
        for bkv in range(b * kv):
            bb, kvh = bkv // kv, bkv % kv
            parts = []
            for t0, t1 in p.shares(kt):
                pk = torch.zeros(len(ks), hd)
                pv = torch.zeros(len(ks), hd)
                for t in range(t0, t1):
                    hh = kvh * group + t // per_head
                    q0 = (qt_first + t % per_head) * fa.QUERY_STEP
                    qs = torch.arange(q0, min(q0 + fa.QUERY_STEP, s))
                    pt = probs(bb, hh, qs, ks).T
                    dpt = vf[bb, ks, kvh] @ dof[bb, qs, hh].T
                    dst = pt * (dpt - delta[bb, hh, qs][None, :])
                    pv += pt @ dof[bb, qs, hh]
                    pk += dst @ qf[bb, qs, hh]
                parts.append((pk, pv))
            fk, fv = torch.zeros(len(ks), hd), torch.zeros(len(ks), hd)
            for pk, pv in parts:  # share order, whichever block ends last
                fk += pk
                fv += pv
            dk[bb, ks, kvh] = fk * scale
            dv[bb, ks, kvh] = fv
    return dq, dk, dv


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jgrad(causal):
    def loss(q, k, v, do):
        out = JL.chunked_attention(q, k, v, causal=causal, chunk=64)
        return jnp.sum(out * do)
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))


def _close(got, want, tol=1e-5, msg=""):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    bound = tol * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= bound, msg


@pytest.mark.parametrize("b,s,h,kv,hd,causal,chunk", [
    (1, 300, 4, 2, 16, True, None),    # the plan: shares (5, 3, 1)
    (1, 300, 4, 2, 16, True, 1),       # one step a block
    (2, 200, 6, 2, 16, False, None),   # full attention, group 3
    (1, 150, 2, 2, 32, True, 100),     # no split (MHA)
])
def test_replay_matches_jax_grad(b, s, h, kv, hd, causal, chunk):
    q, k, v, do = (_normal(i, shape) for i, shape in enumerate(
        [(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd)]))
    want = _jgrad(causal)(*(jnp.asarray(x) for x in (q, k, v, do)))
    got = _replay(*(torch.from_numpy(x) for x in (q, k, v, do)), causal,
                  chunk=chunk)
    for name, g, w in zip("qkv", got, want):
        _close(g.numpy(), w, msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_replay_with_s_valid_matches_the_plain_version(causal):
    """Keys at or past s_valid carry no mass (their dK, dV are zero); the
    reference's chunked_attention has no s_valid, so the plain version's
    autograd is the yardstick here."""
    q, k, v, do = (torch.from_numpy(_normal(10 + i, shape)) for i, shape in
                   enumerate([(1, 260, 4, 16), (1, 260, 2, 16),
                              (1, 260, 2, 16), (1, 260, 4, 16)]))
    got = _replay(q, k, v, do, causal, s_valid=170)
    want = ref.flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                       s_valid=170)
    for name, g, w in zip("qkv", got, want):
        _close(g.numpy(), w.numpy(), msg=f"d{name}")
    assert float(got[1][:, 170:].abs().max()) == 0.0


def test_d_from_p_and_dp_holds_where_the_output_remainder_misses():
    """dQ with D = rowsum(P o dP) from fp32 P and dP stays within 1e-6 of
    the exact chain rule (fp64) at key means up to 10; with D from the
    forward's bf16 output plus its bf16 remainder (the output the forward
    kernel forms, P as bf16 hi + lo, split into two bf16 halves) it misses
    that by an order of magnitude, and from the bf16 output alone by three
    (tools/flash_bwd_delta_error.py prints the same table)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "flash_bwd_delta_error.py"
    spec = importlib.util.spec_from_file_location("delta_error", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for mean in (0.0, 1.0, 3.0, 10.0):
        errs = tool.dq_errors(mean)
        assert errs["rowsum(P dP) fp32"] <= 1e-6, (mean, errs)
        assert errs["bf16 O + O_lo"] > 10 * errs["rowsum(P dP) fp32"]
        assert errs["bf16 O"] > 1e3 * errs["rowsum(P dP) fp32"]


@pytest.mark.parametrize("hd,split", [(128, True), (64, True), (128, False)])
def test_bwd_dispatch_passes_the_plan(hd, split, monkeypatch):
    """The tensor-core route launches one entry with the plan's chunk, a
    workspace of the plan's size (empty where no tile is split) and its
    counters, and counts one launch."""
    calls = []
    monkeypatch.setattr(_build, "check", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=5))
    monkeypatch.setattr(fa, "_sms", lambda index: fa.H100_SMS)
    kernels.reset_launch_counts()
    b, s, h, kv = (4, 1024, 24, 2) if split else (4, 512, 8, 8)
    q, do = (torch.zeros((b, s, h, hd), dtype=torch.bfloat16)
             for _ in range(2))
    k, v = (torch.zeros((b, s, kv, hd), dtype=torch.bfloat16)
            for _ in range(2))
    lse = torch.zeros((b, h, s))
    seen = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: seen.append(
        (a, kw.get("dtype"))) or real_empty(*a, **kw))
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, do, lse, causal=True)
    p = fa.plan(b, s, h, kv, hd, True)
    assert [c[0] for c in calls] == ["flash_attention_bwd"]
    args = calls[0][1:]
    assert len(args) == 11 + 9 + 1 + 1 + 1 + 1
    assert args[11:21] == (b, s, s, h, kv, hd, hd, s, 1,
                           1.0 / math.sqrt(hd))
    assert args[21:] == (p.chunk, None, 5)
    assert ((p.workspace_floats,), torch.float32) in seen
    assert ((p.counters,), torch.int32) in seen
    assert (p.workspace_floats > 0) == split
    assert kernels.launch_counts()["flash_attention_bwd"] == 1
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
