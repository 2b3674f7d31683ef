"""The port's kernel layer (repro_torch.kernels) against the JAX package's.

On the CPU ``repro_torch.kernels.ops`` runs the plain PyTorch versions and
``repro.kernels.ops`` runs the Pallas kernels in interpret mode; both get the
same numpy inputs.  The CUDA kernels themselves run only on the card and are
held against these plain versions by ``chip_smoke.py``.  Tolerance: rtol
1e-5 (both sides sum fp32 products, in different orders), with an atol of
1e-5 where outputs pass through zero (raw dots).
"""
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
from repro_torch.kernels.leaf_scores import leaf_scores
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
], ids=["zstats", "block_scores", "leaf_scores"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches its CUDA kernel or raises: a CPU tensor is refused
    before anything is built, and no launch is counted."""
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()
    assert kernels.launch_counts() == {"zstats": 0, "block_scores": 0,
                                       "leaf_scores": 0, "fused_lse": 0,
                                       "fused_lse_bwd": 0}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_check_refuses_non_cuda_devices(device):
    with pytest.raises(ValueError, match="CUDA"):
        _build.check("x", torch.empty(4, 4, device=device), 2)


def test_ops_refuse_mixed_devices():
    with pytest.raises(ValueError, match="devices"):
        ops.leaf_dots(torch.zeros(2, 4), torch.zeros(2, 3, 4, device="meta"))


def test_build_library_path_tracks_source_and_flags():
    """Libraries are cached by a hash of source + flags, one per source
    (the two fused-head kernels share one), in build/repro_torch/ (a
    directory .gitignore lists)."""
    paths = {name: _build.library_path(name) for name in _build.SIGNATURES}
    assert len(set(paths.values())) == 4
    assert paths["fused_lse"] == paths["fused_lse_bwd"]
    for name, p in paths.items():
        src = _build.source(name)
        assert p.parent == _build.BUILD_DIR
        assert p.name.startswith(src.stem + "-") and p.suffix == ".so"
        assert src.is_file() and src.parent.name == "csrc"
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
