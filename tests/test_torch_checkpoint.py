"""The port's checkpoints (``repro_torch.checkpoint``), checkpoint/restart in
``fit`` and ``serving_index_source``, on the CPU.

The reference's ``tests/test_checkpoint.py`` cases on torch states
(roundtrip, keep-K, async wait, no ``.tmp`` left, a kill during a save, an
async failure surfacing on ``wait``, a re-save over a final directory,
serialized async saves, the fsync order), its crash-and-restart case of
``tests/test_train_loop.py`` on the port's ``fit``, and checkpoints crossing
both ways: the port restores a youtube-dnn and a ptb-lstm checkpoint the
reference's ``fit`` wrote and takes a step at fixed negatives with the
reference's loss (rtol 1e-5, fp32 sums in other orders); the reference
restores the port's checkpoint of that state bitwise; the manifests' keys
are equal.
"""
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.core import estimators as jest
from repro.data.pipeline import batch_iterator_for as jbatch_iterator_for
from repro.models import api as japi
from repro.optim import make_optimizer as jmake_optimizer
from repro.sharding.rules import local_ctx
from repro.train.loop import fit as jfit
from repro_torch import convert
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import estimators
from repro_torch.data.pipeline import batch_iterator_for
from repro_torch.models import api
from repro_torch.optim import make_optimizer
from repro_torch.serve import retrieval
from repro_torch.serve.quantized_index import QuantizedRetrievalIndex
from repro_torch.train import loop, step

torch.set_num_threads(1)

CTX = local_ctx()


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.zeros((4,))},
            "step": torch.tensor(seed, dtype=torch.int32)}


def _like():
    return {"params": {"w": torch.empty((8, 4), device="meta"),
                       "b": torch.empty((4,), device="meta")},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _restore(mgr, step=None):
    return mgr.restore(like=_like(), step=step, device="cpu")


# -- the reference's manager cases --------------------------------------------

def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    st = _state(3)
    mgr.save(3, st, extra={"step": 3, "data_state": {"seed": 1, "step": 9}},
             blocking=True)
    restored, extra = _restore(mgr)
    for a, b in ((st["params"]["w"], restored["params"]["w"]),
                 (st["params"]["b"], restored["params"]["b"]),
                 (st["step"], restored["step"])):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert extra["data_state"] == {"seed": 1, "step": 9}
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        assert json.load(f) == {
            "step": 3, "extra": extra,
            "keys": ["params/b", "params/w", "step"]}


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s), blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_latest_and_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for s in (10, 20):
        mgr.save(s, _state(s), blocking=True)
    assert int(_restore(mgr, step=10)[0]["step"]) == 10
    assert int(_restore(mgr)[0]["step"]) == 20


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(7, _state(7), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 7


def test_save_copies_to_the_host_before_it_returns(tmp_path, monkeypatch):
    """The next train step updates the parameters in place: an async save
    must hold the values of the moment it was called."""
    gate = threading.Event()
    real_savez = np.savez

    def late_savez(f, **arrays):
        gate.wait(5)
        return real_savez(f, **arrays)

    monkeypatch.setattr(manager_mod.np, "savez", late_savez)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    st = _state(4)
    want = st["params"]["w"].clone()
    mgr.save(4, st, blocking=False)
    st["params"]["w"].add_(1.0)  # the optimizer's in-place update
    gate.set()
    mgr.wait()
    assert torch.equal(_restore(mgr)[0]["params"]["w"], want)


def test_no_tmp_dirs_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, _state(1), blocking=True)
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_kill_during_save_restores_latest_complete(tmp_path, monkeypatch):
    """A crash before the rename: the torn step never lists or restores,
    the latest complete one does, and a relaunch re-saving the same step
    succeeds over the leftover debris."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(10, _state(10), blocking=True)
    real_replace = os.replace

    def killed_replace(src, dst):
        raise RuntimeError("injected kill before rename")

    monkeypatch.setattr(manager_mod.os, "replace", killed_replace)
    with pytest.raises(RuntimeError, match="injected kill"):
        mgr.save(20, _state(20), blocking=True)
    monkeypatch.setattr(manager_mod.os, "replace", real_replace)
    assert mgr.all_steps() == [10]
    assert int(_restore(mgr)[0]["step"]) == 10

    mgr2 = CheckpointManager(str(tmp_path), keep=3)
    mgr2.save(20, _state(20), blocking=True)
    assert mgr2.all_steps() == [10, 20]
    assert int(_restore(mgr2)[0]["step"]) == 20


def test_kill_during_async_save_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=3)

    def killed_replace(src, dst):
        raise RuntimeError("injected async kill")

    monkeypatch.setattr(manager_mod.os, "replace", killed_replace)
    mgr.save(5, _state(5), blocking=False)
    with pytest.raises(RuntimeError, match="background checkpoint write"):
        mgr.wait()
    assert mgr.all_steps() == []


def test_resave_over_existing_final_dir(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(7, _state(1), blocking=True)
    with open(tmp_path / "step_00000007" / "stray.txt", "w") as f:
        f.write("debris")
    mgr.save(7, _state(2), blocking=True)
    assert int(_restore(mgr, step=7)[0]["step"]) == 2
    assert not (tmp_path / "step_00000007" / "stray.txt").exists()


def test_overlapping_async_saves_are_serialized(tmp_path, monkeypatch):
    active, peak = [0], [0]
    lock = threading.Lock()
    real_savez = np.savez

    def slow_savez(f, **arrays):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.02)
        try:
            return real_savez(f, **arrays)
        finally:
            with lock:
                active[0] -= 1

    monkeypatch.setattr(manager_mod.np, "savez", slow_savez)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(1, 6):
        mgr.save(s, _state(s), blocking=False)
    mgr.wait()
    assert peak[0] == 1, f"{peak[0]} write() bodies ran concurrently"
    assert mgr.all_steps() == [4, 5]


def test_fsync_contract(tmp_path, monkeypatch):
    events = []
    real_fsync, real_replace = os.fsync, os.replace
    monkeypatch.setattr(
        manager_mod.os, "fsync",
        lambda fd: (events.append("fsync"), real_fsync(fd))[1])
    monkeypatch.setattr(
        manager_mod.os, "replace",
        lambda s, d: (events.append("replace"), real_replace(s, d))[1])
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, _state(1), blocking=True)
    ren = events.index("replace")
    assert events[:ren].count("fsync") >= 3, events
    assert "fsync" in events[ren:], events


def test_missing_array_raises_a_named_key_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, {"step": torch.tensor(1, dtype=torch.int32)}, blocking=True)
    with pytest.raises(KeyError, match="has no array 'params/w'"):
        _restore(mgr)


# -- fit: crash and restart ---------------------------------------------------

def _cfg():
    return get_config("youtube-dnn").reduced()


def test_crash_restart_resumes_identically(tmp_path):
    """Run A: 30 steps straight.  Run B: crash at 17, restart, finish from
    step 10.  The losses after the restart equal run A's bitwise (the data
    iterator and the steps' generators are pure functions of (seed, step),
    and the CPU step is deterministic)."""
    cfg = _cfg()
    opt = make_optimizer("adamw", 3e-3)

    def run(ckpt_dir, fail_at=None):
        data = batch_iterator_for(cfg, None, 32, 1, seed=1, device="cpu")
        return loop.fit(cfg, None, opt, data, 30, log_every=0,
                        checkpoint_dir=ckpt_dir, checkpoint_every=10,
                        fail_at_step=fail_at, device="cpu")

    res_a = run(str(tmp_path / "a"))
    assert res_a.restored_from is None
    with pytest.raises(RuntimeError, match="injected failure"):
        run(str(tmp_path / "b"), fail_at=17)
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [10]
    res_b = run(str(tmp_path / "b"))
    assert res_b.restored_from == 10
    assert res_b.losses == res_a.losses[10:]
    assert CheckpointManager(str(tmp_path / "a")).all_steps() == [10, 20, 30]


def test_a_failing_step_lets_the_inflight_save_land(tmp_path, monkeypatch):
    """fit raising mid-run first lets the checkpoint it already copied to
    the host land, so the relaunch resumes from it."""
    real_savez = np.savez

    def slow_savez(f, **arrays):
        time.sleep(0.3)
        return real_savez(f, **arrays)

    monkeypatch.setattr(manager_mod.np, "savez", slow_savez)
    cfg = _cfg()
    data = batch_iterator_for(cfg, None, 8, 1, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        loop.fit(cfg, None, make_optimizer("sgd", 0.1), data, 6,
                 log_every=0, checkpoint_dir=str(tmp_path),
                 checkpoint_every=2, fail_at_step=3, device="cpu")
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]


@pytest.mark.parametrize("sampler", ["block-quadratic", "tree-quadratic",
                                     "rff", "midx"])
def test_abstract_train_state_is_init_on_meta(sampler):
    """abstract_train_state has init_train_state's structure, shapes and
    dtypes, on the meta device."""
    cfg = get_config("youtube-dnn").reduced(sampler=sampler)
    opt = make_optimizer("adamw", 1e-2)
    real = step.init_train_state(torch.Generator().manual_seed(0), cfg,
                                 None, opt, device="cpu")
    meta = step.abstract_train_state(cfg, None, opt)
    got = manager_mod._leaves(manager_mod._reference_form(meta))
    want = manager_mod._leaves(manager_mod._reference_form(real))
    assert [k for k, _ in got] == [k for k, _ in want]
    assert meta.step == real.step == 0  # a host int: ".step" on the host
    for (k, a), (_, b) in zip(got, want):
        assert a.device.type == ("cpu" if k == ".step" else "meta"), k
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k


def test_serving_index_source_skips_a_torn_step(tmp_path):
    """poll() serves the newest complete step, returns None when nothing
    new landed, and a torn step (manifest present, arrays unreadable)
    reads as nothing new until it is whole."""
    cfg = _cfg()
    opt = make_optimizer("adamw", 1e-2)
    data = batch_iterator_for(cfg, None, 16, 1, seed=2, device="cpu")
    res = loop.fit(cfg, None, opt, data, 4, log_every=0,
                   checkpoint_dir=str(tmp_path), checkpoint_every=2,
                   device="cpu")
    poll = step.serving_index_source(str(tmp_path), cfg, None, opt,
                                     device="cpu")
    index, served = poll()
    assert served == 4 and poll() is None
    h = torch.randn((5, index.wq.shape[-1]),
                    generator=torch.Generator().manual_seed(0))
    want = retrieval.decode_topk(
        step.export_retrieval_index(res.state, cfg, None), h, 10)
    got = retrieval.decode_topk(index, h, 10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    torn = tmp_path / "step_00000006"
    os.makedirs(torn)
    with open(torn / "manifest.json", "w") as f:
        json.dump({"step": 6, "extra": {}, "keys": []}, f)
    with open(torn / "arrays.npz", "wb") as f:
        f.write(b"PK\x03\x04 truncated")
    assert poll() is None
    CheckpointManager(str(tmp_path), keep=5).save(6, res.state,
                                                  blocking=True)
    assert poll()[1] == 6 and poll() is None
    qpoll = step.serving_index_source(str(tmp_path), cfg, None, opt,
                                      quantized=True, device="cpu")
    qindex, served = qpoll()
    assert served == 6 and qpoll() is None
    assert isinstance(qindex, QuantizedRetrievalIndex)
    assert qindex.bits == cfg.midx_bits == 8


# -- checkpoints across the two packages --------------------------------------

FAMILIES = {"youtube-dnn": (16, 1), "ptb-lstm": (4, 6)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_checkpoints_cross_both_ways(name, tmp_path):
    """The reference's fit writes a checkpoint after two steps.  The port
    restores it (template: abstract_train_state on meta) with the
    reference's keys, arrays bitwise, and takes a step at fixed negatives
    with the reference's loss and gradients; the port's checkpoint of that
    state restores in the reference bitwise, under the same keys."""
    jcfg = jget_config(name).reduced()
    cfg = get_config(name).reduced()
    batch_size, seq = FAMILIES[name]
    jopt = jmake_optimizer("adamw", 1e-2)
    opt = make_optimizer("adamw", 1e-2)
    jdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    data = jbatch_iterator_for(jcfg, CTX, global_batch=batch_size,
                               seq_len=seq, seed=3)
    jres = jfit(jcfg, CTX, jopt, data, 2, checkpoint_dir=jdir, log_every=0,
                max_len=8)

    # the reference's checkpoint -> the port
    mine, extra = CheckpointManager(jdir).restore(
        like=step.abstract_train_state(cfg, None, opt), device="cpu")
    assert mine.step == 2 and extra["step"] == 2
    assert all(p.device.type == "cpu" for p in mine.params.parameters())
    jstate = jres.state
    want = dict(manager_mod._flatten(mine))
    with np.load(os.path.join(jdir, "step_00000002", "arrays.npz")) as npz:
        assert sorted(npz.files) == sorted(want)
        for k in npz.files:
            assert npz[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(want[k], npz[k], err_msg=k)

    batch_np = _np_tree(next(jbatch_iterator_for(
        jcfg, CTX, global_batch=batch_size, seq_len=seq, seed=9)))
    t = batch_np["labels"].size
    rng = np.random.default_rng(1)
    neg = rng.integers(0, cfg.vocab_size, (t, cfg.m_negatives)
                       ).astype(np.int32)
    logq = np.log(rng.uniform(1e-4, 1e-2, neg.shape)).astype(np.float32)

    def jloss(params):
        hh, lab, _ = japi.backbone_hidden(params, batch_np, jcfg, CTX)
        return jnp.mean(jest.loss_from_embeddings(
            jest.make_estimator(jcfg.estimator),
            japi.head_table(params, jcfg), hh, lab, neg, logq,
            abs_mode=jcfg.abs_softmax))
    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(jstate.params)
    batch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                                 else v.copy())
             for k, v in batch_np.items()}
    hh, lab, _ = api.backbone_hidden(mine.params, batch, cfg)
    loss = torch.mean(estimators.loss_from_embeddings(
        estimators.make_estimator(cfg.estimator),
        api.head_table(mine.params, cfg), hh, lab,
        torch.from_numpy(neg.astype(np.int64)), torch.from_numpy(logq),
        abs_mode=cfg.abs_softmax, impl=cfg.head_impl))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    jg = convert._flat_params(_np_tree(jgrads))
    for pname, p in mine.params.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), jg[pname], rtol=1e-5,
            atol=1e-5 * float(np.abs(jg[pname]).max()), err_msg=pname)

    # the port's checkpoint -> the reference
    CheckpointManager(pdir).save(2, mine, extra={"step": 2}, blocking=True)
    back, jextra = JCheckpointManager(pdir).restore(like=jstate)
    assert jextra == {"step": 2}
    for path, leaf in jax.tree_util.tree_flatten_with_path(back)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        assert np.asarray(leaf).dtype == want[key].dtype, key
        np.testing.assert_array_equal(np.asarray(leaf), want[key],
                                      err_msg=key)
    manifests = []
    for d in (jdir, pdir):
        with open(os.path.join(d, "step_00000002", "manifest.json")) as f:
            manifests.append(json.load(f)["keys"])
    assert manifests[0] == manifests[1]
    assert ".step" in manifests[0] and ".params/head/w" in manifests[0]

    # train_state_to_jax is train_state_from_jax's inverse
    np_params, np_opt, np_sampler, n = convert.train_state_to_jax(mine)
    again = convert.train_state_from_jax(np_params, np_opt, np_sampler, n,
                                         cfg, device="cpu")
    assert {k: v.tolist() for k, v in manager_mod._flatten(again).items()} \
        == {k: v.tolist() for k, v in want.items()}
