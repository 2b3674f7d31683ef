"""The port's youtube-dnn tower, configs, converters and package rules
against the JAX package, on the CPU.

Tolerance of the tower: rtol 1e-5 (fp32 matmuls in other orders)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.sharding.rules import local_ctx
from repro.utils import misc as jmisc
from repro_torch import convert
from repro_torch.configs import get_config, list_archs
from repro_torch.data.pipeline import batch_iterator_for
from repro_torch.models import api
from repro_torch.models.layers import dense_init
from repro_torch.optim import make_optimizer
from repro_torch.serve import retrieval
from repro_torch.train import loop, step
from repro_torch.utils import misc

torch.set_num_threads(1)

CTX = local_ctx()
REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["youtube-dnn", "ptb-lstm"])
def test_configs_equal_the_reference(name):
    assert name in list_archs()
    mine, theirs = get_config(name), jget_config(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(mine.reduced()) == \
        dataclasses.asdict(theirs.reduced())
    assert mine.layer_kinds() == theirs.layer_kinds()
    assert api.hidden_width(mine) == japi.hidden_width(theirs)


def test_misc_helpers_match_reference():
    for x in (1, 2, 3, 5, 64, 100, 1023, 1024):
        assert misc.next_pow2(x) == jmisc.next_pow2(x)
    for x in (1, 2, 1024):
        assert misc.log2_int(x) == jmisc.log2_int(x)
    with pytest.raises(ValueError):
        misc.log2_int(6)


def _jax_params(cfg, seed=0):
    params = japi.init_params(jax.random.PRNGKey(seed), cfg, CTX)
    return jax.tree_util.tree_map(np.asarray, params)


def test_tower_from_jax_params_matches_hidden_states():
    """Weights carried over by params_from_jax give the same h as the
    reference tower at reduced width, and the same head table."""
    jcfg = jget_config("youtube-dnn").reduced()
    cfg = get_config("youtube-dnn").reduced()
    np_params = _jax_params(jcfg)
    model = convert.params_from_jax(np_params, cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"history": rng.integers(0, cfg.vocab_size, (9, cfg.history_len)
                                     ).astype(np.int32),
             "user_feats": rng.normal(size=(9, cfg.user_feature_dim)
                                      ).astype(np.float32),
             "labels": rng.integers(0, cfg.vocab_size, (9,)).astype(np.int32)}
    jh, jlab, _ = japi.backbone_hidden(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, CTX)
    with torch.no_grad():
        h, lab, aux = api.backbone_hidden(
            model, {k: torch.from_numpy(v).long() if v.dtype == np.int32
                    else torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert h.shape == (9, api.hidden_width(cfg))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    assert float(aux) == 0.0
    np.testing.assert_array_equal(
        api.head_table(model, cfg).detach().numpy(),
        np.asarray(japi.head_table(np_params, jcfg)))


def test_init_params_shapes_and_scales():
    cfg = get_config("youtube-dnn").reduced(vocab_size=2048)
    model = api.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    ref = japi.init_params(jax.random.PRNGKey(1), jget_config(
        "youtube-dnn").reduced(vocab_size=2048), CTX)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {"embed_table": ref["embed"]["table"].shape,
                      "head_w": ref["head"]["w"].shape,
                      **{f"tower_{k}": v.shape
                         for k, v in ref["tower"].items()}}
    # same distributions: head/embed std 0.05, tower std 1/sqrt(fan_in)
    assert float(model.head_w.detach().std()) == pytest.approx(0.05,
                                                               rel=0.05)
    w0 = model.tower_w0.detach()
    assert float(w0.std()) == pytest.approx(1 / np.sqrt(w0.shape[0]),
                                            rel=0.05)
    assert not model.tower_b0.detach().any()
    x = dense_init(torch.Generator().manual_seed(0), (4, 3), torch.float32,
                   torch.device("cpu"))
    assert x.shape == (4, 3) and x.dtype == torch.float32


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    """No device and no CUDA: raise, never carry on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("youtube-dnn").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        retrieval.build_index(np.zeros((64, 8), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_jax({}, cfg)
    # the training slice's entry points
    opt = make_optimizer("adamw", 1e-2)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_iterator_for(cfg, None, 4, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        step.init_train_state(torch.Generator(), cfg, None, opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.fit(cfg, None, opt, iter(()), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.train_state_from_jax({}, ((), {}), {}, 0, cfg)


def test_unported_families_raise():
    lstm = get_config("ptb-lstm").reduced()
    with pytest.raises(NotImplementedError, match="lstm"):
        api.init_params(lstm, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="lstm"):
        convert.params_from_jax({}, lstm, device="cpu")


def test_index_from_jax_refuses_sharded_indexes():
    with pytest.raises(NotImplementedError):
        convert.index_from_jax({"tp": 2}, device="cpu")


#: modules of the training slice, which the walk below must reach
TRAINING_MODULES = (
    "repro_torch.kernels.fused_head", "repro_torch.core.kernel_fns",
    "repro_torch.core.blocks", "repro_torch.core.samplers",
    "repro_torch.core.sampled_softmax", "repro_torch.core.estimators",
    "repro_torch.optim.transform", "repro_torch.optim.clip",
    "repro_torch.optim.adamw", "repro_torch.optim.sgd",
    "repro_torch.optim.schedule", "repro_torch.data.synthetic",
    "repro_torch.data.pipeline", "repro_torch.train.step",
    "repro_torch.train.loop")


def test_port_imports_neither_jax_nor_the_reference():
    """Every repro_torch module (the training slice's included), and
    chip_smoke.py's imports, load without jax or any module of the JAX
    package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {TRAINING_MODULES!r} "
        "if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('ok', len([m for m in sys.modules "
        "if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert int(out.stdout.split()[1]) >= 40
