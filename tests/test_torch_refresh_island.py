"""The port's overlapped sampler-stat refresh (``refresh_mode="overlap"``,
``train/loop.py::RefreshIsland``) on the CPU, where the island's rebuild
runs inline: the cases of the reference's ``tests/test_refresh_island.py``
(validation, the fixed-k staleness sawtooth and swap count, run-to-run
determinism, still learning, the inert dense estimator, snapshots at
dispatch, sync-mode staleness), with the staleness and swaps also held
against the reference's own ``fit`` on the same config.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import batch_iterator_for as jbatch_iterator_for
from repro.optim import make_optimizer as jmake_optimizer
from repro.sharding.rules import local_ctx
from repro.train.loop import fit as jfit
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core.samplers import sampler_from_config
from repro_torch.data.pipeline import batch_iterator_for
from repro_torch.models import api
from repro_torch.optim import make_optimizer
from repro_torch.train import loop, step

torch.set_num_threads(1)

SMALL = dict(vocab_size=256, m_negatives=32, sampler_block=32,
             tower_dims=(64, 32), user_feature_dim=64, history_len=3)


def _cfg(**kw):
    return dataclasses.replace(get_config("youtube-dnn").reduced(**SMALL),
                               **kw)


def _run(cfg, steps=24, seed=0):
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    data = batch_iterator_for(cfg, None, 32, 1, seed=seed, device="cpu")
    return loop.fit(cfg, None, opt, data, steps, log_every=0, device="cpu")


# -- config validation --------------------------------------------------------

def test_unknown_refresh_mode_rejected():
    with pytest.raises(ValueError, match="refresh_mode"):
        _cfg(refresh_mode="async").validate()


def test_nonpositive_stale_steps_rejected():
    with pytest.raises(ValueError, match="refresh_stale_steps"):
        _cfg(refresh_stale_steps=0).validate()


def test_stale_steps_must_fit_inside_cadence():
    with pytest.raises(ValueError, match="must be <"):
        _cfg(refresh_mode="overlap", sampler_refresh_every=4,
             refresh_stale_steps=4).validate()
    _cfg(refresh_mode="overlap", sampler_refresh_every=1,
         refresh_stale_steps=3).validate()


# -- refresh fn ---------------------------------------------------------------

def _state(cfg):
    return step.init_train_state(torch.Generator().manual_seed(0), cfg,
                                 None, make_optimizer("adamw", 1e-2),
                                 device="cpu")


def test_refresh_fn_matches_in_step_rebuild():
    cfg = _cfg()
    state = _state(cfg)
    refresh = step.make_refresh_fn(cfg, None)
    assert refresh.carries_stats
    head = api.head_table(state.params, cfg)
    out = refresh(head, state.sampler_state)
    direct = sampler_from_config(cfg).build_stats(
        head.detach(), cfg.vocab_size, state.sampler_state.const)
    assert set(out.stats) == set(direct)
    for k, v in direct.items():
        assert torch.equal(out.stats[k], v), k


def test_refresh_fn_output_shares_no_buffers_with_input():
    cfg = _cfg(sampler_proj_rank=16)
    state = _state(cfg)
    out = step.make_refresh_fn(cfg, None)(
        api.head_table(state.params, cfg), state.sampler_state)
    ins = {t.data_ptr() for t in (*state.sampler_state.stats.values(),
                                  *state.sampler_state.const.values())}
    assert state.sampler_state.const  # the projection is carried
    for t in out.stats.values():
        assert t.data_ptr() not in ins


# -- overlap loop behaviour ---------------------------------------------------

def test_overlap_staleness_pattern_and_swaps():
    """cadence 4, k 2: dispatch at 0, 4, 8, ..., swap at 2, 6, 10, ...;
    staleness follows the fixed-k sawtooth (prime() makes the first window
    start at 0), as the reference's fit reports on the same config."""
    cfg = _cfg(refresh_mode="overlap", sampler_refresh_every=4,
               refresh_stale_steps=2)
    res = _run(cfg, steps=14)
    assert res.refresh_staleness == [0, 1, 2, 3, 4, 5, 2, 3, 4, 5, 2, 3, 4, 5]
    assert res.refresh_swaps == 3
    assert np.all(np.isfinite(res.losses))
    jcfg = dataclasses.replace(
        jget_config("youtube-dnn").reduced(**SMALL), refresh_mode="overlap",
        sampler_refresh_every=4, refresh_stale_steps=2)
    jres = jfit(jcfg, local_ctx(), jmake_optimizer("adamw", 1e-2),
                jbatch_iterator_for(jcfg, local_ctx(), global_batch=32,
                                    seq_len=0, seed=0),
                steps=14, log_every=0, max_len=8)
    assert jres.refresh_staleness == res.refresh_staleness
    assert jres.refresh_swaps == res.refresh_swaps
    assert np.all(np.isfinite(jax.device_get(jres.losses)))


def test_overlap_is_deterministic_run_to_run():
    cfg = _cfg(refresh_mode="overlap", sampler_refresh_every=4,
               refresh_stale_steps=2)
    a = _run(cfg, steps=20, seed=5)
    b = _run(cfg, steps=20, seed=5)
    assert a.losses == b.losses  # bitwise
    assert a.refresh_swaps == b.refresh_swaps
    assert a.refresh_staleness == b.refresh_staleness


def test_overlap_still_learns():
    cfg = _cfg(refresh_mode="overlap", sampler_refresh_every=2,
               refresh_stale_steps=1)
    res = _run(cfg, steps=60)
    assert np.mean(res.losses[-10:]) < np.mean(res.losses[:10]) - 0.05


def test_overlap_with_dense_estimator_is_inert():
    cfg = _cfg(refresh_mode="overlap", estimator="full",
               sampler_refresh_every=4, refresh_stale_steps=2)
    res = _run(cfg, steps=4)
    assert res.refresh_swaps == 0
    assert res.refresh_staleness == [0, 0, 0, 0]
    assert np.all(np.isfinite(res.losses))


def test_dispatch_inputs_are_snapshots():
    """The tensors handed to an in-flight rebuild are copies, never the
    live state's head or sampler tensors (the optimizer updates the
    parameters in place)."""
    cfg = _cfg(refresh_mode="overlap", sampler_refresh_every=4,
               refresh_stale_steps=2)
    state = _state(cfg)
    island = loop.RefreshIsland(cfg, None, "cpu")
    assert island.enabled
    live = {t.data_ptr() for t in state.sampler_state.stats.values()} | {
        api.head_table(state.params, cfg).data_ptr()}
    snap = island._snap_state(state.sampler_state)
    head = island._snapshot(state.params)
    assert not head.requires_grad
    got = {t.data_ptr() for t in snap.stats.values()} | {head.data_ptr()}
    assert live and got and not (live & got)
    state = island.prime(state)
    state, _ = island.before_step(0, state)
    sent, h0, s0, _, done = island._inflight
    assert sent == 0 and done is None
    assert h0.data_ptr() != api.head_table(state.params, cfg).data_ptr()


def test_island_counts_its_launches_apart():
    """The island's rebuild launches no kernel on the CPU, and its
    counter starts from zero for every kernel."""
    cfg = _cfg(refresh_mode="overlap", sampler_refresh_every=1,
               refresh_stale_steps=1)
    island = loop.RefreshIsland(cfg, None, "cpu")
    kernels.reset_launch_counts()
    state = island.prime(_state(cfg))
    for i in range(3):
        state, tele = island.before_step(i, state)
        assert tele["refresh_staleness_steps"] == (0 if i == 0 else 1)
    assert set(island.launches) == set(kernels.launch_counts())
    assert set(island.launches.values()) == {0}
    assert island.swaps == 2


def test_sync_mode_reports_cadence_staleness():
    cfg = _cfg(refresh_mode="sync", sampler_refresh_every=3)
    res = _run(cfg, steps=9)
    assert res.refresh_staleness == [0, 1, 2, 0, 1, 2, 0, 1, 2]
    assert res.refresh_swaps == 0
