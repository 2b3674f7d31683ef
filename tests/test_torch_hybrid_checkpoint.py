"""The MoE, SSM and hybrid families' train states through the checkpoint
manager, their batches, and what a finished ``fit`` leaves behind, on the
CPU.

* falcon-mamba-7b, jamba-v0.1-52b and dbrx-132b at ``reduced()``, fp32 and
  bf16, with the reference's ``chain(clip, adafactor)`` state: the
  reference's manager's save restores in the port (template:
  ``abstract_train_state`` on meta) under the same keys, arrays bitwise;
  the port's save of it has the same keys and arrays, and (fp32; the
  reference cannot place the ``|V2`` arrays numpy writes for bf16)
  restores in the reference bitwise.
* ``batch_iterator_for`` gives the three families SyntheticLM's chain.
* No reference to a train state outlives its caller: after ``fit`` with a
  checkpoint (a save with its writer joined), after a ``restore`` and
  after ``serving_index_source``'s poll, weak references to every
  parameter and optimizer moment are dead once the caller drops its
  result, with the cyclic garbage collector off (a reference cycle would
  otherwise hold the state until the collector happens to run); and in a
  fresh process, the first remat call keeps no caller's tensors alive.
"""
import gc
import os
import subprocess
import sys
import weakref
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.optim import make_optimizer as jmake_optimizer
from repro.sharding.rules import local_ctx
from repro.train import step as jstep
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import batch_iterator_for
from repro_torch.models import transformer
from repro_torch.optim import make_optimizer
from repro_torch.train import loop, step

torch.set_num_threads(1)

CTX = local_ctx()
ARCHS = ("falcon-mamba-7b", "jamba-v0.1-52b", "dbrx-132b")


def _flat_np(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_adafactor_checkpoints_cross_both_ways(arch, dtype, tmp_path):
    jcfg = jget_config(arch).reduced(dtype=dtype, param_dtype=dtype)
    cfg = get_config(arch).reduced(dtype=dtype, param_dtype=dtype)
    jopt = jmake_optimizer("adafactor", 1e-2)
    opt = make_optimizer("adafactor", 1e-2)
    jstate = jax.jit(lambda key: jstep.init_train_state(key, jcfg, CTX, jopt,
                                                        max_len=8))(
        jax.random.PRNGKey(1))
    jdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    JCheckpointManager(jdir).save(3, jstate, extra={"step": 3},
                                  blocking=True)
    mine, extra = CheckpointManager(jdir).restore(
        like=step.abstract_train_state(cfg, None, opt), device="cpu")
    assert extra == {"step": 3} and mine.step == int(jstate.step)
    assert isinstance(mine.params, transformer.StackedLM)
    want = dict(manager_mod._flatten(mine))
    assert any("/vr" in k for k in want) and any("/vc" in k for k in want)
    with np.load(f"{jdir}/step_00000003/arrays.npz") as npz:
        assert sorted(npz.files) == sorted(want)
        for k in npz.files:
            assert npz[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(want[k], npz[k], err_msg=k)
    CheckpointManager(pdir).save(3, mine, extra={"step": 3}, blocking=True)
    with np.load(f"{pdir}/step_00000003/arrays.npz") as npz:
        assert sorted(npz.files) == sorted(want)
        for k in npz.files:
            assert npz[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(npz[k], want[k], err_msg=k)
    if dtype == "float32":
        back, jextra = JCheckpointManager(pdir).restore(like=jstate)
        assert jextra == {"step": 3}
        got, ref = _flat_np(back), _flat_np(jstate)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_families_batches_are_the_lm_chain(arch):
    cfg = get_config(arch).reduced()
    dense = get_config("starcoder2-3b").reduced(vocab_size=cfg.vocab_size)
    a = next(batch_iterator_for(cfg, None, 3, 7, seed=4, device="cpu"))
    b = next(batch_iterator_for(dense, None, 3, 7, seed=4, device="cpu"))
    assert set(a) == {"tokens", "labels"}
    for k in a:
        assert torch.equal(a[k], b[k])


def _refs(state) -> list:
    tensors = list(state.params.parameters()) + [
        t for t in jax.tree_util.tree_leaves(state.opt_state)
        if isinstance(t, torch.Tensor)]
    return [weakref.ref(t) for t in tensors]


def _alive(refs) -> int:
    return sum(r() is not None for r in refs)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "jamba-v0.1-52b"])
def test_no_train_state_outlives_its_caller(arch, tmp_path, monkeypatch):
    cfg = get_config(arch).reduced()
    opt = make_optimizer("adamw", 1e-2)
    ckpt = str(tmp_path / "ckpt")
    restored = []
    export = step.export_quantized_index

    def spy(state, *args, **kw):
        restored.extend(_refs(state))
        return export(state, *args, **kw)

    monkeypatch.setattr(step, "export_quantized_index", spy)
    gc.collect()
    gc.disable()
    try:
        res = loop.fit(cfg, None, opt, batch_iterator_for(
            cfg, None, 2, 8, device="cpu"), 2, checkpoint_dir=ckpt,
            checkpoint_every=1, log_every=0, device="cpu")
        refs = _refs(res.state)
        assert len(refs) > 2 * len(list(res.state.params.parameters()))
        del res
        assert _alive(refs) == 0, "fit's state"
        back, _ = CheckpointManager(ckpt).restore(
            like=step.abstract_train_state(cfg, None, opt), device="cpu")
        refs = _refs(back)
        del back
        assert _alive(refs) == 0, "a restored state"
        poll = step.serving_index_source(ckpt, cfg, None, opt,
                                         quantized=True, device="cpu")
        index, at = poll()
        assert at == 2 and restored
        assert _alive(restored) == 0, "the poll's restored state"
    finally:
        gc.enable()


def test_the_first_remat_call_keeps_no_caller_alive():
    """In a fresh process (``torch._dynamo`` not yet imported), the first
    remat forward and backward, then dropping the model: a weak
    reference to its parameters is dead with the cyclic collector off
    (``torch.utils.checkpoint`` imports ``torch._dynamo`` at its first call,
    an import that cycles over its callers' frames unless the port made
    it at module level)."""
    code = (
        "import gc, weakref, torch\n"
        "gc.disable()\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import api, transformer\n"
        "cfg = get_config('falcon-mamba-7b').reduced(remat=True)\n"
        "m = api.init_module(cfg, torch.Generator().manual_seed(0), "
        "device='cpu')\n"
        "h, _ = transformer.hidden_states(m, torch.zeros((1, 8), "
        "dtype=torch.long), cfg)\n"
        "h.sum().backward()\n"
        "ref = weakref.ref(next(m.parameters()))\n"
        "del m, h\n"
        "print('ALIVE' if ref() is not None else 'DEAD')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parents[1] / "src"),
         os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "DEAD"
