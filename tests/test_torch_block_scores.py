"""The tilings of ``block_scores`` and ``leaf_scores`` (their ``plan``s) on
the CPU, and ``block_scores``' tile decomposition against the JAX package.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against their plain versions.  Here each plan is checked at every shape
``chip_smoke.py`` runs: its tiles or chunks cover the output once, its
units of work (``block_scores``) or 1-D grid (``leaf_scores``) stay under
2^31 - 1, and ``block_scores``' workspace has the partials' shape.
Then the arithmetic of ``block_scores``' two kernels is replayed in fp32
PyTorch (a partial per (I, J) tile of Z_n, in the plan's order, the
partials summed in a fixed order) and held against
``repro.kernels.ops.block_scores`` (the Pallas kernel in interpret mode)
within 1e-5 relative: both sum fp32 products, in different orders, and
the outputs (alpha * |W h|^2 + cnt) stay away from zero.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import block_scores as bsm
from repro_torch.kernels import leaf_scores as lsm

torch.set_num_threads(1)

INT_MAX = 2**31 - 1
#: (T, N, r) of every block_scores call chip_smoke.py makes: the training
#: root, the tree's and serving's nine dense levels (2 to 512 nodes) at T
#: 256, 16 and 1, the ragged T 19 at r 200, r 4,096 at T 16 and 40, the
#: ragged T 257, N 1, r 1,100 and r 1,101 (4-byte copies of Z), and r
#: 3,625 (past the old 3,624 limit)
BLOCK_SHAPES = (
    [(256, 391, 128)]
    + [(t, 2**k, 128) for t in (256, 16, 1) for k in range(1, 10)]
    + [(19, 5, 200), (16, 8, 4096), (40, 8, 4096), (257, 5, 128),
       (16, 1, 4096), (16, 3, 1100), (19, 3, 1100), (19, 3, 1101),
       (3, 2, 3625)])
#: (G, B, r) of every leaf_scores / midx_member_scores call: llama3-8b's
#: full beam, training's and serving's leaf steps, the ragged G and widths
LEAF_SHAPES = [(128, 4096, 4096), (32768, 256, 128), (4096, 128, 128),
               (4093, 128, 128), (4093, 256, 128), (37, 50, 126),
               (3, 4097, 4096), (5, 300, 4094)]


def _partition(n: int, size: int, count: int) -> list[tuple[int, int]]:
    """[start, stop) of ``count`` tiles of ``size`` over n, checked to
    cover [0, n) once, in order."""
    spans = [(k * size, min(n, (k + 1) * size)) for k in range(count)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a < b for a, b in spans)  # no empty tile
    assert all(spans[k][1] == spans[k + 1][0] for k in range(count - 1))
    return spans


@pytest.mark.parametrize("t,n,r", BLOCK_SHAPES)
def test_block_scores_plan_covers_the_output_once(t, n, r):
    p = bsm.plan(t, n, r)
    assert (p.tq, p.bj, p.m) in bsm.TILINGS  # the kernel's instantiations
    assert p.bi % bsm.CHUNK_ROWS == 0
    _partition(t, p.tq, p.n_qt)
    _partition(r, p.bi, p.n_i)
    _partition(r, p.bj, p.n_j)
    assert p.units == n * p.n_qt * p.n_i * p.n_j <= INT_MAX
    tiles = p.n_i * p.n_j
    assert p.workspace == ((n, t, tiles) if tiles > 1 else (0,))


@pytest.mark.parametrize("t,n,r", [(16, 8, 4096), (16, 1, 4096),
                                   (16, 512, 128), (256, 391, 128)])
def test_block_scores_plan_fills_the_card(t, n, r):
    """The timed shapes give every one of an H100's 132 SMs ~2 units of
    work: at r = 4,096 by splitting the 8 nodes' rows, which gave 8 blocks
    in all when a block took a whole node."""
    assert bsm.plan(t, n, r).units >= bsm.TARGET_UNITS


def test_block_scores_plan_refuses_units_past_int_max():
    with pytest.raises(ValueError, match="2\\^31"):
        bsm.layout(16, 2**22, 4096, 16, 128, 4, 128)


def _replay(h, z, cnt, alpha, p):
    """The two kernels' arithmetic: V = h[:, I] Z_n[I, J] and its dot with
    h[:, J] per tile (ti, tj), the partials summed in tile order."""
    t, r = h.shape
    s = None
    for i0, i1 in _partition(r, p.bi, p.n_i):
        for j0, j1 in _partition(r, p.bj, p.n_j):
            v = torch.einsum("ti,nij->ntj", h[:, i0:i1], z[:, i0:i1, j0:j1])
            part = (v * h[None, :, j0:j1]).sum(-1)  # (N, T)
            s = part if s is None else s + part
    return (alpha * s + cnt[:, None]).T


@pytest.mark.parametrize("t,n,r,tiling", [
    (16, 3, 128, (16, 128, 4, 128)),  # one tile per node: no combine
    (16, 3, 128, None),               # rows split by the plan: 4 x 32
    (40, 3, 128, None),               # 8 x 8 micro-tiles, rows split
    (257, 2, 128, None),              # a partial query tile
    (16, 3, 256, (16, 128, 4, 64)),   # 4 x 2 tiles
    (19, 3, 200, None),               # ragged: 6 x 32 + 8 rows, 128 + 72
    (5, 2, 200, (16, 128, 4, 96)),    # ragged rows: 96 + 96 + 8
    (40, 2, 200, (64, 128, 8, 64)),   # 8 x 8, ragged rows and columns
    (16, 2, 1100, None),              # 18 x 9 tiles, both ragged
    (19, 2, 1100, None),
    (19, 2, 1101, None),              # r % 4 != 0: 12 x 9 tiles
])
def test_block_scores_tiles_replay_the_reference(t, n, r, tiling):
    p = bsm.plan(t, n, r) if tiling is None else bsm.layout(t, n, r, *tiling)
    rng = np.random.default_rng(t * 1000 + r)
    h = (rng.normal(size=(t, r)) * 0.5).astype(np.float32)
    w = (rng.normal(size=(n, 32, r)) * 0.5).astype(np.float32)
    z = np.array(jref.zstats_ref(w))
    cnt = np.arange(n, dtype=np.float32) + 1
    want = np.asarray(jops.block_scores(jnp.asarray(h), jnp.asarray(z),
                                        jnp.asarray(cnt), alpha=100.0))
    got = _replay(*map(torch.from_numpy, (h, z, cnt)), 100.0, p)
    assert got.shape == (t, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("g,b,r", LEAF_SHAPES)
def test_leaf_scores_plan_covers_the_rows_once(g, b, r):
    p = lsm.plan(g, b, r)
    # the kernel's two variants: eight float4 of one row from r = 1,024
    # on, one float4 of each of eight rows below
    assert p.unroll == (lsm.LOADS if r >= 1024 else 1)
    per_pass = lsm.ROW_WARPS * (lsm.LOADS // p.unroll)
    assert p.chunk % per_pass == 0  # whole warp passes
    _partition(b, p.chunk, p.n_chunks)
    assert p.grid == g * p.n_chunks <= INT_MAX


def test_leaf_scores_plan_splits_wide_leaves():
    """llama3-8b's full beam, 128 leaves of 4,096 rows, gets at least
    ~4 blocks per SM, where one block per leaf left 4 of 132 SMs idle."""
    assert lsm.plan(128, 4096, 4096).grid >= lsm.TARGET_BLOCKS
    assert lsm.plan(32768, 256, 128).n_chunks == 1


def test_leaf_scores_plan_refuses_a_grid_past_int_max():
    with pytest.raises(ValueError, match="2\\^31"):
        lsm.plan(2**31, 1, 128)
