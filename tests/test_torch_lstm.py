"""The port's ptb-lstm slice — ``models/lstm_lm.py``, its ``models/api.py``
branches, ``SyntheticLM`` and the LM branch of ``batch_iterator_for``, the
lstm family of ``convert`` — against the JAX package, on the CPU, at
``get_config("ptb-lstm").reduced()`` (2 layers of 32 units, vocab 512).

Deterministic parts on the same numpy inputs and converted parameters:
hidden states within 1e-5, and gradients of a fixed random projection of
them within 1e-5 of each tensor's largest entry (fp32 sums in other
orders); one ``_cell`` step; the synthetic chain's transition logits and
entropy on the reference's own tables; the sampled-softmax loss and every
gradient of one train step at fixed negatives, from a reference train
state carried across.  The chain's draws are held to its transition
distribution by the chi-square/TV gate of ``tests/test_sampler_stats.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import estimators as jest
from repro.data.pipeline import batch_iterator_for as jbatch_iterator_for
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.models import api as japi
from repro.models import lstm_lm as jlstm
from repro.optim import make_optimizer as jmake_optimizer
from repro.sharding.rules import local_ctx
from repro.train import step as jstep
from repro_torch import convert, kernels
from repro_torch.configs import get_config
from repro_torch.core import estimators
from repro_torch.data.pipeline import batch_iterator_for
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import api, lstm_lm
from repro_torch.optim import make_optimizer
from repro_torch.train import loop, step
from test_sampler_stats import _check_against

torch.set_num_threads(1)

CTX = local_ctx()
JCFG = jget_config("ptb-lstm").reduced()
CFG = get_config("ptb-lstm").reduced()

_jinit = jax.jit(lambda k: jlstm.init_lstm_lm(k, JCFG, CTX))
_jhidden = jax.jit(lambda p, tok: jlstm.hidden_states(p, tok, JCFG, CTX)[0])


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _params(seed: int) -> dict:
    """Reference params as numpy, with random biases (the init's are 0) so
    that the bias path is compared too."""
    params = _np_tree(_jinit(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for i in range(JCFG.lstm_layers):
        b = params[f"lstm{i}"]["bias"]
        params[f"lstm{i}"]["bias"] = (rng.normal(size=b.shape) * 0.3
                                      ).astype(np.float32)
    return params


def _close_max(got, want, rtol=1e-5, msg=""):
    """Within ``rtol`` of the tensor's largest entry (and of each entry)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=msg)


def test_config_is_the_papers_ptb_model():
    cfg = get_config("ptb-lstm")
    assert (cfg.family, cfg.vocab_size, cfg.lstm_layers, cfg.lstm_units,
            cfg.sampler, cfg.sampler_block, cfg.m_negatives,
            cfg.abs_softmax) == ("lstm", 10_000, 2, 200, "block-quadratic",
                                 128, 128, True)
    assert api.hidden_width(cfg) == 200
    assert api.hidden_width(CFG) == 32 == JCFG.lstm_units
    assert "lstm" in api.PORTED_FAMILIES


def test_init_draws_the_references_names_and_scales():
    """``init_lstm_lm``: the reference's parameters under flat names, embed
    and head std 0.05, kernels std 1/sqrt(u), biases 0; the head table is
    ``head_w`` itself (gradients reach it)."""
    model = api.init_params(CFG, torch.Generator().manual_seed(0),
                            device="cpu")
    assert isinstance(model, lstm_lm.LSTMLM)
    u, v = CFG.lstm_units, CFG.vocab_size
    want = {"embed_table": (v, u), "head_w": (v, u)}
    for i in range(CFG.lstm_layers):
        want.update({f"lstm{i}_kernel": (u, 4 * u),
                     f"lstm{i}_recurrent": (u, 4 * u),
                     f"lstm{i}_bias": (4 * u,)})
    got = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert got == want
    flat = convert._flat_params(_params(0))
    assert {k: v.shape for k, v in flat.items()} == want
    for name, p in model.named_parameters():
        if name.endswith("_bias"):
            assert float(p.detach().abs().max()) == 0.0
        else:
            scale = 0.05 if name in ("embed_table", "head_w") else u ** -0.5
            assert abs(float(p.detach().std()) / scale - 1.0) < 0.1, name
    assert api.head_table(model, CFG) is model.head_w


@pytest.mark.parametrize("batch,seq", [(3, 7), (1, 1), (4, 12)])
def test_hidden_states_and_grads_match_reference(batch, seq):
    """Converted params: h within 1e-5, and the gradients of sum(h * R) for
    a fixed random R within 1e-5 of each tensor's largest entry."""
    params = _params(batch * 10 + seq)
    rng = np.random.default_rng(seq)
    tokens = rng.integers(0, CFG.vocab_size, (batch, seq)).astype(np.int32)
    proj = rng.normal(size=(batch, seq, CFG.lstm_units)).astype(np.float32)
    want_h = np.asarray(_jhidden(params, tokens))
    jgrads = jax.jit(jax.grad(
        lambda p: jnp.sum(_jhidden(p, tokens) * proj)))(params)

    model = convert.params_from_jax(params, CFG, device="cpu")
    h, aux = lstm_lm.hidden_states(model, torch.from_numpy(tokens).long(),
                                   CFG)
    assert h.shape == (batch, seq, CFG.lstm_units) and float(aux) == 0.0
    _close_max(h.detach().numpy(), want_h)
    torch.sum(h * torch.from_numpy(proj)).backward()
    want = convert._flat_params(_np_tree(jgrads))
    assert model.head_w.grad is None and not want["head_w"].any()
    for name, p in model.named_parameters():
        if name != "head_w":
            _close_max(p.grad.numpy(), want[name], msg=name)


def test_cell_matches_reference_with_the_forget_bias():
    rng = np.random.default_rng(4)
    u = 8
    p = {"kernel": rng.normal(size=(u, 4 * u)),
         "recurrent": rng.normal(size=(u, 4 * u)),
         "bias": rng.normal(size=(4 * u,))}
    p = {k: (v * 0.4).astype(np.float32) for k, v in p.items()}
    x, h, c = (rng.normal(size=(5, u)).astype(np.float32) for _ in range(3))
    jh, jc = jax.jit(jlstm._cell)(p, x, h, c)
    th, tc = lstm_lm._cell({k: torch.from_numpy(v) for k, v in p.items()},
                           *map(torch.from_numpy, (x, h, c)))
    _close_max(th.numpy(), jh)
    _close_max(tc.numpy(), jc)
    # all gates 0: c' = sigmoid(0 + 1) c + sigmoid(0) tanh(0) = sigmoid(1) c
    zero = {k: torch.zeros_like(torch.from_numpy(v)) for k, v in p.items()}
    ones = torch.ones((2, u))
    h1, c1 = lstm_lm._cell(zero, ones, ones, ones)
    np.testing.assert_allclose(c1.numpy(), 1.0 / (1.0 + np.exp(-1.0)),
                               rtol=1e-6)
    np.testing.assert_allclose(h1.numpy(), 0.5 * np.tanh(c1.numpy()),
                               rtol=1e-6)


def _lm_pair(vocab=64, seed=3):
    jlm = JSyntheticLM(vocab_size=vocab, seed=seed)
    e, c = (torch.from_numpy(np.array(x)) for x in jlm._tables())
    return jlm, SyntheticLM(vocab_size=vocab, seed=seed, device="cpu",
                            tables=(e, c))


def _jtransitions(jlm, prev):
    e, c = jlm._tables()
    return (c[prev] @ e.T) * (jlm.temperature / np.sqrt(jlm.rank))


def test_synthetic_lm_on_the_references_tables_matches():
    """The same transition logits, and ``chain_entropy`` over the
    reference's own prev ids, within 1e-5."""
    jlm, lm = _lm_pair()
    prev = np.arange(64)
    _close_max(lm.transition_logits(torch.from_numpy(prev)).numpy(),
               _jtransitions(jlm, prev))
    jprev = np.array(jax.random.randint(jax.random.PRNGKey(1), (256,), 0,
                                          64))
    np.testing.assert_allclose(
        lm.chain_entropy(prev=torch.from_numpy(jprev).long()),
        jlm.chain_entropy(), rtol=1e-5)
    assert 0.0 < lm.chain_entropy() < np.log(64)


def test_synthetic_lm_draws_pass_the_chi_square_gate():
    """60,000 chains of two steps from uniform first tokens: the first
    step's draws follow the mean transition row, the second's that row
    pushed once more through the transition matrix (the reference's)."""
    jlm, lm = _lm_pair()
    batch = lm.sample_batch(torch.Generator().manual_seed(0), 60_000, 2)
    tokens, labels = batch["tokens"], batch["labels"]
    assert tokens.shape == labels.shape == (60_000, 2)
    assert tokens.dtype == labels.dtype == torch.int64
    assert torch.equal(tokens[:, 1], labels[:, 0])
    trans = np.asarray(jax.nn.softmax(_jtransitions(jlm, np.arange(64)),
                                      axis=-1), dtype=np.float64)
    q1 = trans.mean(axis=0)
    q2 = q1 @ trans
    _check_against(labels[:, 0].numpy(), q1 / q1.sum(), "SyntheticLM step 1")
    _check_against(labels[:, 1].numpy(), q2 / q2.sum(), "SyntheticLM step 2")


def test_lm_batches_and_resumable_iterator():
    data = batch_iterator_for(CFG, None, 4, 9, seed=5, device="cpu")
    b0 = next(data)
    assert b0["tokens"].shape == b0["labels"].shape == (4, 9)
    assert torch.equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])
    assert int(b0["labels"].max()) < CFG.vocab_size
    saved = data.state_dict()
    b1 = next(data)
    again = batch_iterator_for(CFG, None, 4, 9, seed=5, device="cpu")
    again.load_state(saved)
    b1_again = next(again)
    for k in b1:
        assert torch.equal(b1[k], b1_again[k])


def test_train_step_at_fixed_negatives_matches_reference():
    """A reference train state (params, AdamW state, the block sampler's
    statistics) carried across: the statistics and optimizer state arrive
    unchanged, and the sampled-softmax loss and every gradient at the same
    (params, batch, neg_ids, logq) agree within 1e-5."""
    jopt = jmake_optimizer("adamw", 1e-2)
    state_j = jax.jit(lambda k: jstep.init_train_state(k, JCFG, CTX, jopt))(
        jax.random.PRNGKey(0))
    ss = state_j.sampler_state
    mine = convert.train_state_from_jax(
        _np_tree(state_j.params), _np_tree(state_j.opt_state),
        {"stats": _np_tree(ss.stats), "const": _np_tree(ss.const)},
        int(state_j.step), CFG, device="cpu")
    assert isinstance(mine.params, lstm_lm.LSTMLM)
    names = {k for k, _ in mine.params.named_parameters()}
    assert set(mine.opt_state[1]["m"]) == set(mine.opt_state[1]["v"]) == \
        names
    for k, v in ss.stats.items():
        np.testing.assert_array_equal(mine.sampler_state.stats[k].numpy(),
                                      np.asarray(v), err_msg=k)

    batch_np = _np_tree(next(jbatch_iterator_for(JCFG, CTX, global_batch=4,
                                                 seq_len=6, seed=3)))
    t, m = 4 * 6, CFG.m_negatives
    rng = np.random.default_rng(1)
    neg = rng.integers(0, CFG.vocab_size, (t, m)).astype(np.int32)
    neg[:3, 0] = batch_np["labels"].reshape(-1)[:3]  # accidental hits
    logq = np.log(rng.uniform(1e-4, 1e-2, (t, m))).astype(np.float32)

    def jloss(params):
        hh, lab, _ = japi.backbone_hidden(params, batch_np, JCFG, CTX)
        return jnp.mean(jest.loss_from_embeddings(
            jest.make_estimator(JCFG.estimator),
            japi.head_table(params, JCFG), hh, lab, neg, logq,
            abs_mode=JCFG.abs_softmax))
    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(state_j.params)

    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in batch_np.items()}
    hh, lab, _ = api.backbone_hidden(mine.params, batch, CFG)
    assert hh.shape == (t, CFG.lstm_units)
    loss = torch.mean(estimators.loss_from_embeddings(
        estimators.make_estimator(CFG.estimator),
        api.head_table(mine.params, CFG), hh, lab,
        torch.from_numpy(neg.astype(np.int64)), torch.from_numpy(logq),
        abs_mode=CFG.abs_softmax, impl=CFG.head_impl))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = convert._flat_params(_np_tree(jgrads))
    for name, p in mine.params.named_parameters():
        _close_max(p.grad.numpy(), want[name], msg=name)


def test_fit_runs_three_reduced_steps_on_the_cpu():
    """``fit`` through the whole ptb-lstm path (block-quadratic refresh
    every step, sampling, the fused head's plain path, clip + AdamW) on the
    CPU: three finite losses; no CUDA kernel is launched."""
    opt = make_optimizer("adamw", 1e-2, weight_decay=0.0)
    data = batch_iterator_for(CFG, None, 4, 8, seed=0, device="cpu")
    kernels.reset_launch_counts()
    res = loop.fit(CFG, None, opt, data, 3, log_every=0, device="cpu")
    losses = np.asarray(res.losses)
    assert losses.shape == (3,) and np.isfinite(losses).all()
    assert res.state.step == 3 and isinstance(res.state.params,
                                              lstm_lm.LSTMLM)
    assert set(kernels.launch_counts().values()) == {0}
    shapes = step.init_train_state(torch.Generator().manual_seed(0), CFG,
                                   None, opt, device="cpu")
    assert {k: tuple(v.shape) for k, v in
            shapes.sampler_state.stats.items()} == \
        {k: tuple(v.shape) for k, v in res.state.sampler_state.stats.items()}
