"""The fused head's CUDA decomposition (``fused_head.plan``) on the CPU, and
the backward's deterministic dL/dw pass replayed against the JAX package.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against their plain versions and two calls against each other, bitwise.
Here the plan is checked at every shape ``chip_smoke.py`` runs: the token
blocks' warp passes take every slot of a token once, the sort chunks and
their warps every slot once, the tiles every row once, the lists every
tile once, the runs and the workspace fit.  Then the dL/dw pass is
replayed in fp32 PyTorch step by step (per-warp and per-chunk counts of
each list scanned into one list per list tile, the lists cut into runs,
each run's rows summed ``acc = acc + p * h`` in list order, split lists'
runs' partials folded in a fixed order) on
numpy-seeded ids, uniform and skewed
(90% of the slots on 3 rows).  Where no list is split it equals the sum in
ascending slot order bitwise; always it equals the JAX package's
``_chunked_lse_bwd`` and, on a small case, its Pallas ``fused_lse_bwd`` in
interpret mode within rtol 1e-5 / atol 1e-6 (fp32 sums of the same terms
in other orders).  Last, the wrappers' launch arguments are the plan's.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_head as jfh
from repro.kernels import ops as jops
from repro_torch import kernels
from repro_torch.kernels import _build, fused_head, ops

torch.set_num_threads(1)

INT_MAX = 2**31 - 1
TR = fused_head.TILE_ROWS
#: (T, K, d, n) of every fused-head call chip_smoke.py makes: the training
#: shape (also the real step's and the pool run's skewed ids, fp32 and
#: bf16) and the two ragged widths
CHIP_SHAPES = [(256, 129, 128, 100_000), (37, 17, 200, 1000),
               (37, 17, 126, 1000)]
#: shapes of this file's replays
SMALL_SHAPES = [(37, 17, 24, 700), (5, 9, 16, 64), (3, 4, 8, 130)]


def _cover(spans, n):
    """The [a, b) spans cover [0, n) once."""
    hits = np.zeros(n, dtype=int)
    for a, b in spans:
        assert 0 <= a < b <= n
        hits[a:b] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("t,k,d,n", CHIP_SHAPES + SMALL_SHAPES)
def test_plan_covers_every_slot_row_and_column_once(t, k, d, n):
    p = fused_head.plan(t, k, d, n)
    s = t * k
    # a token block's warps, GROUP slots a pass, passes strided by warps
    for warps in (p.warps, p.fwd_warps):
        assert 1 <= warps <= fused_head.MAX_WARPS
        _cover([(g0, min(k, g0 + fused_head.GROUP))
                for w in range(warps)
                for g0 in range(w * fused_head.GROUP, k,
                                warps * fused_head.GROUP)], k)
    assert p.fwd_warps == min(fused_head.MAX_WARPS,
                              -(-k // fused_head.GROUP))
    strip_cap = fused_head.DH_SMEM // (p.col_chunks * fused_head.COL_CHUNK
                                       * 4)
    assert p.warps == min(max(p.fwd_warps, fused_head.SORT_WARPS),
                          strip_cap)
    # sort chunks over the T K slots, the warps' whole 32-slot steps over
    # each chunk
    assert p.chunk % 32 == 0 and p.n_chunks <= fused_head.MAX_CHUNKS
    _cover([(c * p.chunk, min(s, (c + 1) * p.chunk))
            for c in range(p.n_chunks)], s)
    for c in range(p.n_chunks):
        size = min(s, (c + 1) * p.chunk) - c * p.chunk
        span = _span(size, p.warps)
        assert span % 32 == 0
        _cover([(w * span, min(size, (w + 1) * span))
                for w in range(p.warps) if w * span < size], size)
    # tiles of rows, lists of q tiles, column chunks
    _cover([(x * TR, min(n, (x + 1) * TR)) for x in range(p.n_tiles)], n)
    _cover([(x * p.q, min(p.n_tiles, (x + 1) * p.q))
            for x in range(p.n_lists)], p.n_tiles)
    assert p.warps * p.n_lists * 4 <= fused_head.SORT_SMEM
    assert p.n_lists <= fused_head.MAX_LISTS
    _cover([(c * fused_head.COL_CHUNK, min(d, (c + 1) * fused_head.COL_CHUNK))
            for c in range(p.col_chunks)], d)
    # runs: every run of a list has a block, split lists partials
    assert p.run >= fused_head.MIN_RUN and p.run & (p.run - 1) == 0
    assert -(-s // p.run) <= fused_head.MAX_RUNS
    assert p.units == p.n_lists + -(-s // p.run) <= INT_MAX
    assert p.partials * p.run >= 2 * s
    assert p.workspace == sum(fused_head.workspace_parts(
        s, d, p.n_chunks, p.q, p.n_lists, p.n_tiles, p.run, p.partials,
        p.col_chunks).values())


def test_plan_training_shape():
    """K = 129 takes one pass of 17 warps; 17 sort chunks of 2,048 slots;
    a list per 4 tiles of 64 rows (391 lists), runs of 256; the workspace
    stays within PARTIAL_BYTES."""
    p = fused_head.plan(256, 129, 128, 100_000)
    assert (p.fwd_warps, p.warps) == (17, 17)
    assert (p.chunk, p.n_chunks) == (2048, 17)
    assert (p.q, p.n_lists, p.n_tiles, p.run) == (4, 391, 1563, 256)
    assert p.workspace * 4 <= fused_head.PARTIAL_BYTES


@pytest.mark.parametrize("t,k", [(2**16, 2**15 + 1), (2**20, 2**11 + 1)])
def test_plan_refuses_slots_past_int32(t, k):
    assert t * k > INT_MAX
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        fused_head.plan(t, k, 128, 1000)


def test_plan_sizes_its_lists_past_2_15_slots_and_long_heads():
    """Slot counts past 2^15 and heads past the sort block's shared memory
    are sized for: a llama-width call (T 2,176, K 513: 2^20 slots, 128,256
    rows of 4,096) fits its dh strips in 6 warps, runs of 2^16 keep its
    partials in PARTIAL_BYTES; a 1,000,000-row head lists 32 tiles a
    list."""
    p = fused_head.plan(2176, 513, 4096, 128_256)
    assert p.warps == 6 and p.n_lists <= fused_head.MAX_LISTS
    assert p.warps * p.col_chunks * fused_head.COL_CHUNK * 4 \
        <= fused_head.DH_SMEM
    assert p.partials * p.q * TR * 4096 * 4 <= 1.01 * fused_head.PARTIAL_BYTES
    assert -(-2176 * 513 // p.run) <= fused_head.MAX_RUNS
    p = fused_head.plan(256, 129, 128, 1_000_000)
    assert p.q == 32 and p.n_lists <= fused_head.MAX_LISTS


# --- the dL/dw pass, replayed ------------------------------------------------


def _span(size: int, warps: int) -> int:
    """Slots of a chunk each sort warp takes: whole steps of 32 (csrc
    sort_chunk)."""
    return -(-(-(-size // warps)) // 32) * 32


def _ids(t, k, n, skew, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, (t, k)).astype(np.int32)
    if skew:  # 90% of the slots on 3 rows
        hot = rng.choice(n, 3, replace=False)
        on = rng.random((t, k)) < 0.9
        ids[on] = rng.choice(hot, int(on.sum()))
    return ids


def _sort_lists(ids: torch.Tensor, p) -> tuple[torch.Tensor, ...]:
    """The sort blocks and the scan kernel: in each chunk, per-warp counts
    of each list scanned over the warps give every slot its rank among
    the chunk's slots of its list (a warp's steps in order, a slot's rank
    in its step's group of the same list); the chunks' counts summed and
    scanned over lists give the lists' starts; a slot's place is its
    list's start, the earlier chunks' counts and its rank.
    -> (lst, etot, toff)."""
    flat = ids.reshape(-1).long()
    s = flat.numel()
    lt = torch.clamp(flat // (p.q * TR), max=p.n_lists)
    lt[flat < 0] = -1
    cnt = torch.zeros((p.n_chunks, p.n_lists), dtype=torch.long)
    rk = torch.full((s,), -1, dtype=torch.long)
    for c in range(p.n_chunks):
        first = c * p.chunk
        size = min(s, first + p.chunk) - first
        span = _span(size, p.warps)
        seen = torch.zeros(p.n_lists, dtype=torch.long)  # earlier warps
        for w in range(p.warps):
            lo = first + w * span
            x = lt[lo:min(first + size, lo + span)]
            ok = torch.nonzero((x >= 0) & (x < p.n_lists)).reshape(-1)
            xs = x[ok]
            order = torch.argsort(xs, stable=True)
            head = torch.searchsorted(xs[order], xs[order])
            rank = torch.empty_like(order)
            rank[order] = torch.arange(order.numel()) - head
            rk[lo + ok] = seen[xs] + rank
            seen += torch.bincount(xs, minlength=p.n_lists)
        cnt[c] = seen
    etot = cnt.sum(0)
    toff = torch.cumsum(etot, 0) - etot
    pre = torch.cumsum(cnt, 0) - cnt  # earlier chunks' counts
    lst = torch.full((s,), -1, dtype=torch.long)
    ok = torch.nonzero((lt >= 0) & (lt < p.n_lists)).reshape(-1)
    lst[toff[lt[ok]] + pre[ok // p.chunk, lt[ok]] + rk[ok]] = ok
    return lst, etot, toff


def _replay_dw(ids, dcoef, h, n, p):
    """The dw kernel: per list, runs of p.run entries; per tile of the
    list, each run's rows summed in list order from 0; a split list's
    runs folded (``_fold``)."""
    t, k = ids.shape
    d = h.shape[1]
    lst, etot, toff = _sort_lists(ids, p)
    flat = ids.reshape(-1).long()
    pf, hf = dcoef.reshape(-1).float(), h.float()
    dw = torch.zeros((n, d), dtype=torch.float32)
    for lid in torch.nonzero(etot).reshape(-1).tolist():
        e = int(etot[lid])
        runs = -(-e // p.run) if e > p.run else 1
        for x in range(lid * p.q, min(p.n_tiles, (lid + 1) * p.q)):
            r0 = x * TR
            rows = min(TR, n - r0)
            parts = []
            for j in range(runs):
                acc = torch.zeros((TR, d), dtype=torch.float32)
                hit = torch.zeros(TR, dtype=torch.bool)
                for slot in lst[toff[lid] + j * p.run:
                                toff[lid] + min(e, (j + 1) * p.run)].tolist():
                    r = int(flat[slot]) - r0
                    if 0 <= r < TR:
                        acc[r] = acc[r] + pf[slot] * hf[slot // k]
                        hit[r] = True
                parts.append((acc, hit))
            dw[r0:r0 + rows] = (parts[0][0] if runs == 1
                                else _fold(parts))[:rows]
    return dw


def _fold(parts):
    """A split list's runs folded as the dw kernel's last block does: 8
    slices of consecutive runs, each a sum in run order of the partials
    that touched a row, then the slices' sums added in slice order."""
    span = -(-len(parts) // 8)
    out = torch.zeros_like(parts[0][0])
    for v in range(8):
        chunk = parts[v * span:(v + 1) * span]
        acc = torch.zeros_like(out)
        any_hit = torch.zeros(out.shape[0], dtype=torch.bool)
        for part, hit in chunk:
            acc = torch.where(hit[:, None], acc + part, acc)
            any_hit |= hit
        out = torch.where(any_hit[:, None], out + acc, out)
    return out




def _ascending(ids, dcoef, h, n):
    """dL/dw summed slot by slot in ascending slot order (Pallas's grid)."""
    k = ids.shape[1]
    dw = torch.zeros((n, h.shape[1]), dtype=torch.float32)
    for s, (i, p) in enumerate(zip(ids.reshape(-1).tolist(),
                                   dcoef.reshape(-1).float())):
        dw[i] = dw[i] + p * h[s // k].float()
    return dw


@pytest.mark.parametrize("t,k,d,n", CHIP_SHAPES[:1] + SMALL_SHAPES)
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("q,chunk", [(None, None), (2, None), (None, 64)])
def test_sort_lays_each_lists_slots_out_in_ascending_order(t, k, d, n, skew,
                                                           q, chunk):
    """Every slot lands once, in its list tile's list, the lists in order
    and each in ascending slot order (the layout the dw pass walks), at
    the plan's lists and chunks, at lists of 2 tiles and at chunks of 64
    slots (several chunks a list at every shape)."""
    p = fused_head.plan(t, k, d, n)
    if q is not None:
        p = p._replace(q=q, n_lists=-(-p.n_tiles // q))
    if chunk is not None:
        p = p._replace(chunk=chunk, n_chunks=-(-t * k // chunk))
    ids = torch.from_numpy(_ids(t, k, n, skew, seed=t + k))
    lst, etot, _ = _sort_lists(ids, p)
    lists = ids.reshape(-1).long() // (p.q * TR)
    want = torch.argsort(lists, stable=True)
    assert torch.equal(lst, want)
    assert int(etot.sum()) == t * k


def _case(t, k, d, n, skew, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(n, d)) * 0.4).astype(np.float32)
    h = (rng.normal(size=(t, d)) * 0.4).astype(np.float32)
    ids = _ids(t, k, n, skew, seed)
    corr = (rng.normal(size=(t, k)) * 0.5).astype(np.float32)
    corr[:, 0] = 0.0
    corr[t // 2, -1] = ops.MASK_CORR
    biasg = (rng.normal(size=(t, k)) * 0.2).astype(np.float32)
    gbar = rng.normal(size=(t,)).astype(np.float32)
    lse = np.array(jops._chunked_lse(jnp.asarray(w), jnp.asarray(h),
                                       jnp.asarray(ids), jnp.asarray(corr),
                                       jnp.asarray(biasg), True))
    return w, h, ids, corr, biasg, lse, gbar


@pytest.mark.parametrize("t,k,d,n", SMALL_SHAPES)
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("run,q", [(None, None), (16, None), (16, 2)])
def test_replayed_dw_matches_the_reference(t, k, d, n, skew, run, q):
    """The replay on the reference's own dcoef, at the plan's runs and at
    runs of 16 (which split the skewed lists), one tile a list and two:
    within rtol 1e-5 / atol 1e-6 of its chunked dL/dw; where no list is
    split, bitwise the sum in ascending slot order."""
    w, h, ids, corr, biasg, lse, gbar = _case(t, k, d, n, skew, seed=t * k)
    dw, _, dcoef, _ = map(np.array, jops._chunked_lse_bwd(
        *map(jnp.asarray, (w, h, ids, corr, biasg, lse, gbar)), True))
    p = fused_head.plan(t, k, d, n)
    if run is not None:
        p = p._replace(run=run)
    if q is not None:  # and chunks of 64 slots
        p = p._replace(q=q, n_lists=-(-p.n_tiles // q), chunk=64,
                       n_chunks=-(-t * k // 64))
    th, tids, tdcoef = map(torch.from_numpy, (h, ids, dcoef))
    got = _replay_dw(tids, tdcoef, th, n, p)
    np.testing.assert_allclose(got.numpy(), dw, rtol=1e-5, atol=1e-6)
    _, etot, _ = _sort_lists(tids, p)
    split = bool((etot > p.run).any())
    if run is None and not skew:
        assert not split  # uniform ids at the plan's runs: one run a tile
    if run is not None and skew and t * k > 4 * run:
        assert split
    if not split:
        assert torch.equal(got, _ascending(tids, tdcoef, th, n))


@pytest.mark.parametrize("skew", [False, True])
def test_replayed_dw_matches_the_pallas_kernel(skew):
    """Against the Pallas ``fused_lse_bwd`` in interpret mode, with runs of
    8 so that the skewed tile is split into several runs and folded."""
    t, k, d, n = 6, 9, 16, 64
    w, h, ids, corr, biasg, lse, gbar = _case(t, k, d, n, skew, seed=5)
    dw, _, dcoef, _ = map(np.array, jfh.fused_lse_bwd(
        *map(jnp.asarray, (w, h, ids, corr, biasg, lse, gbar)),
        abs_mode=True, interpret=True))
    p = fused_head.plan(t, k, d, n)._replace(run=8)
    got = _replay_dw(*map(torch.from_numpy, (ids, dcoef, h)), n, p)
    np.testing.assert_allclose(got.numpy(), dw, rtol=1e-5, atol=1e-6)


# --- launch arguments ----------------------------------------------------------


def _capture(monkeypatch) -> list:
    """Record the wrappers' launches instead of making them (checks pass
    CPU tensors, the stream is 7); a zero fill of dw would raise."""
    calls = []
    monkeypatch.setattr(_build, "check", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=7))
    kernels.reset_launch_counts()
    return calls


@pytest.mark.parametrize("t,k,d,n", CHIP_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launches_take_the_plans_arguments(t, k, d, n, dtype, monkeypatch):
    """fused_lse and fused_lse_bwd launch once each, counted once, with
    (T, K, d) as given, the dtype flag, the plan's warps, chunk, q and run,
    and one int32 workspace of the plan's size; dw is never zero-filled."""
    calls = _capture(monkeypatch)
    w = torch.zeros(1, dtype=dtype).expand(n, d)
    h = torch.zeros(1, dtype=dtype).expand(t, d)
    ids = torch.zeros(1, dtype=torch.int32).expand(t, k)
    z = torch.zeros(1).expand(t, k)
    p = fused_head.plan(t, k, d, n)
    lse = fused_head.fused_lse(w, h, ids, z, z, abs_mode=True)
    assert lse.shape == (t,) and lse.dtype == torch.float32
    name, *ptrs, tt, kk, dd, abs_mode, bf16, warps, _, stream = calls[0]
    assert name == "fused_lse" and len(ptrs) == 6
    assert (tt, kk, dd, abs_mode, stream) == (t, k, d, 1, 7)
    assert (bf16, warps) == (int(dtype == torch.bfloat16), p.fwd_warps)

    def no_zero_fill(*a, **kw):
        raise AssertionError("dw must not be zero-filled")

    monkeypatch.setattr(torch, "zeros", no_zero_fill)
    dw, dh, dcoef, dcorr = fused_head.fused_lse_bwd(
        w, h, ids, z, z, lse, lse, abs_mode=False)
    assert dw.shape == (n, d) and dh.shape == (t, d)
    assert dcoef.shape == dcorr.shape == (t, k)
    assert all(x.dtype == torch.float32 for x in (dw, dh, dcoef, dcorr))
    assert len(calls) == 2
    name, *ptrs = calls[1][:13]
    assert name == "fused_lse_bwd" and len(ptrs) == 12
    rest = calls[1][13:]
    assert rest[:6] == (t, k, d, n, 0, int(dtype == torch.bfloat16))
    assert rest[6:11] == (p.warps, p.chunk, p.q, p.run, p.workspace)
    assert rest[-1] == 7
    assert kernels.launch_counts()["fused_lse"] == 1
    assert kernels.launch_counts()["fused_lse_bwd"] == 1


@pytest.mark.parametrize("w_dtype,h_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
    (torch.float16, torch.float16)])
def test_wrapper_refuses_mixed_or_other_dtypes(w_dtype, h_dtype,
                                               monkeypatch):
    """The kernels take w and h of one dtype, fp32 or bf16 (the device
    check is bypassed for the test); ``ops.fused_head_lse`` upcasts other
    pairs to fp32 before the wrapper sees them."""
    def dtype_only(name, t, ndim, dtype=torch.float32):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")

    monkeypatch.setattr(_build, "check", dtype_only)
    kernels.reset_launch_counts()
    with pytest.raises(TypeError, match="must be"):
        fused_head.fused_lse(torch.zeros(8, 4, dtype=w_dtype),
                             torch.zeros(2, 4, dtype=h_dtype),
                             torch.zeros(2, 3, dtype=torch.int32),
                             torch.zeros(2, 3), torch.zeros(2, 3))
    assert not any(kernels.launch_counts().values())
