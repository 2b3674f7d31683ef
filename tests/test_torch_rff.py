"""The port's rff family (the rff functions of ``core/kernel_fns.py``, the
feature half of ``core/hierarchy.py``, ``ops.rff_features`` and
``RFFSampler``) against the JAX package, on the CPU.

Both sides get the same numpy inputs, the direction matrix omega included
(the two packages' generators never agree).  Deterministic parts are held
within rtol 1e-5 (fp32 sums in other orders; the features are exponentials
of those sums): the features, the shift bound, ``ops.rff_features`` against
the reference's Pallas kernel in interpret mode on ragged shapes, the
built levels, the heap round trip, the exact leaf log-scores and
``all_class_logq``.  Draws are held to the reference's ``all_class_logq``
by the chi-square/TV gate of ``tests/test_sampler_stats.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hierarchy as jhier
from repro.core import kernel_fns as jkf
from repro.kernels import ops as jops
from repro_torch.core import hierarchy, samplers
from repro_torch.core import kernel_fns as kf
from repro_torch.kernels import ops, ref
from test_sampler_stats import _check_against

torch.set_num_threads(1)

D = 12
TAU = 0.7


def _inputs(n, dim=64, seed=0, scale=0.5, t=3):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n, D)) * scale).astype(np.float32),
            rng.normal(size=(dim, D)).astype(np.float32),
            (rng.normal(size=(t, D)) * scale).astype(np.float32))


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


_jbuild = jax.jit(lambda w, leaf, o: jhier.build_features(w, leaf, o, TAU),
                  static_argnums=1)
_jall_class_logq = jax.jit(
    lambda s, o, h: jhier.all_class_logq_features(s, o, TAU, h))


def _stats(w, omega, leaf):
    mine = hierarchy.build_features(torch.from_numpy(w), leaf,
                                    torch.from_numpy(omega), TAU)
    return mine, _jbuild(jnp.asarray(w), leaf, jnp.asarray(omega))


def test_rff_functions_match_reference():
    w, omega, h = _inputs(40, seed=1)
    tw, tom = torch.from_numpy(w), torch.from_numpy(omega)
    _close(kf.rff_log_phi(tw, tom, TAU).numpy(),
           jkf.rff_log_phi(jnp.asarray(w), jnp.asarray(omega), TAU),
           atol=1e-5)
    shift = kf.rff_logshift_bound(tw, tom, TAU)
    jshift = jkf.rff_logshift_bound(jnp.asarray(w), jnp.asarray(omega), TAU)
    assert shift.shape == () and shift.dtype == torch.float32
    _close(float(shift), float(jshift))
    _close(kf.rff_phi(tw, tom, TAU, shift).numpy(),
           jkf.rff_phi(jnp.asarray(w), jnp.asarray(omega), TAU, jshift))
    assert float(kf.rff_logshift_bound(torch.zeros(5, D), tom, TAU)) == 0.0
    om = kf.rff_directions(torch.Generator().manual_seed(0), 64, D)
    assert om.shape == (64, D) and om.dtype == torch.float32


@pytest.mark.parametrize("leaves,b,dim", [(8, 16, 128), (5, 12, 100),
                                          (1, 8, 8), (3, 7, 33)])
def test_ops_rff_features_matches_jax(leaves, b, dim):
    """Ragged shapes: leaf counts off the reference's 8-leaf tiles and
    feature counts off its 128-wide tiles; masked rows in every leaf."""
    rng = np.random.default_rng(leaves * 100 + dim)
    w = (rng.normal(size=(leaves, b, D)) * 0.5).astype(np.float32)
    omega = rng.normal(size=(dim, D)).astype(np.float32)
    mask = (rng.random((leaves, b)) < 0.7).astype(np.float32)
    shift = np.float32(0.3)
    want = np.asarray(jops.rff_features(
        jnp.asarray(w), jnp.asarray(omega), jnp.asarray(mask),
        jnp.asarray(shift), tau=TAU))
    args = (torch.from_numpy(w), torch.from_numpy(omega),
            torch.from_numpy(mask), torch.tensor(shift))
    for got in (ops.rff_features(*args, tau=TAU),
                ref.rff_features_ref(*args, TAU)):
        assert got.shape == (leaves, dim)
        _close(got.numpy(), want)


@pytest.mark.parametrize("n,leaf", [(64, 8), (60, 8), (40, 8)])
def test_build_features_matches_reference(n, leaf):
    """Levels and logshift of the RFF tree, with padding rows (n = 60) and
    padding-only leaves (n = 40) masked out of the feature sums."""
    w, omega, _ = _inputs(n, seed=2)
    mine, theirs = _stats(w, omega, leaf)
    assert mine.depth == theirs.depth and mine.n == theirs.n == n
    assert mine.feature_dim == 64 and mine.logshift.shape == ()
    _close(float(mine.logshift), float(theirs.logshift))
    for lvl in range(mine.depth + 1):
        _close(mine.levels_f[lvl].numpy(), theirs.levels_f[lvl],
               msg=f"level {lvl}")
    _close(mine.wq.numpy(), theirs.wq)
    if n == 40:  # leaves 5..7 hold padding only
        assert float(mine.levels_f[-1][5:].abs().max()) == 0.0


def test_feature_heap_round_trip():
    """The port packs the same heap as the reference (logshift in the aux
    heap's last row), and unpacks it back to its own statistics."""
    w, omega, _ = _inputs(60, seed=3)
    mine, theirs = _stats(w, omega, 8)
    f, aux = hierarchy.to_feature_heap(mine)
    jf, jaux = jhier.to_feature_heap(theirs)
    assert f.shape == jf.shape and aux.shape == jaux.shape == (16,)
    _close(f.numpy(), jf)
    _close(aux.numpy(), jaux)
    back = hierarchy.from_feature_heap(f, aux, mine.wq, 60)
    assert back.n_valid.dtype == torch.int32 and int(back.n_valid) == 60
    assert float(back.logshift) == float(mine.logshift)
    for a, b in zip(back.levels_f, mine.levels_f):
        assert torch.equal(a, b)


def test_leaf_logits_exp_match_reference():
    w, omega, hs = _inputs(60, seed=4)
    mine, theirs = _stats(w, omega, 8)
    leaves = np.array([[0, 7, 7], [6, 7, 1], [2, 5, 4]])
    got = hierarchy.leaf_logits_exp(mine, torch.from_numpy(hs),
                                    torch.from_numpy(leaves), TAU).numpy()
    want = np.asarray(jax.jit(lambda s, h_, i_: jhier.leaf_logits_exp(
        s, h_, i_, TAU, False))(theirs, jnp.asarray(hs),
                                jnp.asarray(leaves)))
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all() and (~finite).any()
    _close(got[finite], want[finite], atol=1e-5)


@pytest.mark.parametrize("n", [64, 60, 40])
def test_all_class_logq_features_matches_reference(n):
    w, omega, hs = _inputs(n, seed=5)
    mine, theirs = _stats(w, omega, 8)
    for h in hs:
        got = hierarchy.all_class_logq_features(
            mine, torch.from_numpy(omega), TAU, torch.from_numpy(h)).numpy()
        want = np.asarray(_jall_class_logq(theirs, jnp.asarray(omega),
                                           jnp.asarray(h)))
        assert got.shape == want.shape == (n,) and np.isfinite(got).all()
        _close(got, want, atol=1e-5)


def test_draw_logq_equals_all_class_logq():
    w, omega, hs = _inputs(60, seed=6)
    mine, _ = _stats(w, omega, 8)
    tom = torch.from_numpy(omega)
    ids, logq = hierarchy.descend_features(
        mine, tom, TAU, torch.from_numpy(hs), 500,
        torch.Generator().manual_seed(0))
    assert ids.shape == logq.shape == (3, 500) and int(ids.max()) < 60
    for t in range(3):
        oracle = hierarchy.all_class_logq_features(mine, tom, TAU,
                                                   torch.from_numpy(hs[t]))
        _close(logq[t].numpy(), oracle[ids[t]].numpy(), atol=1e-5)
    # the gathered form everywhere consumes the generator alike
    ids0, _ = hierarchy.descend_features(
        mine, tom, TAU, torch.from_numpy(hs), 500,
        torch.Generator().manual_seed(0), dense_cap=0)
    assert torch.equal(ids, ids0)


def test_draws_pass_the_chi_square_gate_against_reference():
    """60,000 draws per query at N = 64 (8 leaves of 8), D = 256."""
    w, omega, hs = _inputs(64, dim=256, seed=7)
    mine, theirs = _stats(w, omega, 8)
    ids, _ = hierarchy.descend_features(
        mine, torch.from_numpy(omega), TAU, torch.from_numpy(hs[:2]), 60_000,
        torch.Generator().manual_seed(0))
    for t in range(2):
        q = np.exp(np.asarray(_jall_class_logq(theirs, jnp.asarray(omega),
                                               jnp.asarray(hs[t]))))
        _check_against(ids[t].numpy(), q / q.sum(), f"port rff q{t}")


def test_rff_sampler_protocol_round_trip():
    """init_state draws omega from the generator; build -> heap -> hydrate
    gives ``build_features``' statistics; the cfg's rff knobs are taken."""
    from repro_torch.configs import get_config

    cfg = get_config("youtube-dnn").reduced(vocab_size=200, sampler="rff")
    smp = samplers.sampler_from_config(cfg)
    assert isinstance(smp, samplers.RFFSampler)
    assert (smp.dim, smp.tau, smp.leaf_size) == (64, 1.0, 32)
    rng = np.random.default_rng(8)
    w = torch.from_numpy((rng.normal(size=(200, 16)) * 0.5)
                         .astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    state = smp.init_state(gen, w)
    assert set(state.stats) == {"features", "aux", "wq"}
    assert state.const["omega"].shape == (64, 16)
    runtime = smp.island_runtime(state, w, 200)
    ref_stats = hierarchy.build_features(w, 32, state.const["omega"], 1.0)
    for a, b in zip(runtime["stats"].levels_f, ref_stats.levels_f):
        assert torch.equal(a, b)
    h = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    ids, logq = smp.sample_batch(runtime, h, 8, gen)
    assert ids.shape == (3, 8) and int(ids.max()) < 200
    _close(logq[1].numpy(),
           smp.all_class_logq(runtime, h[1])[ids[1]].numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="sampler_proj_rank"):
        samplers.sampler_from_config(
            get_config("youtube-dnn").reduced(sampler="rff",
                                              sampler_proj_rank=8))
