"""The port's transformer serving steps (``repro_torch.serve.engine``:
``make_prefill_step``, ``make_decode_step``, ``make_topk_step``) against
the JAX package's, on llama3-8b.reduced() (fp32, vocab 512).

Weights come from the reference's ``init_params`` through
``convert.params_from_jax``; prompts from numpy.  Greedy ids must be EQUAL
(both sides take the argmax of fp32 logits, lowest id on a tie); top-k ids
equal, with logits within 1e-5 (fp32, summation order), through the dense
head and through a retrieval index each side builds from its own head at
full beam (exact).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.serve import engine as jengine
from repro.serve import retrieval as jret
from repro.sharding.rules import local_ctx
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.serve import engine, retrieval

torch.set_num_threads(1)

CTX = local_ctx()
JCFG = jget_config("llama3-8b").reduced()
CFG = get_config("llama3-8b").reduced()
B, S, STEPS, K = 2, 10, 8, 5
MAX_LEN = S + STEPS

_jprefill = jax.jit(jengine.make_prefill_step(JCFG, CTX, MAX_LEN))
_jdecode = jax.jit(jengine.make_decode_step(JCFG, CTX))


@functools.lru_cache(maxsize=None)
def _jtopk(use_index: bool):
    if not use_index:
        return jax.jit(jengine.make_topk_step(JCFG, CTX, K))

    def step(params, index, token, caches, pos):
        return jengine.make_topk_step(JCFG, CTX, K, index=index)(
            params, token, caches, pos)

    return jax.jit(step)


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(lambda key: japi.init_params(key, JCFG, CTX))(
        jax.random.PRNGKey(0))
    return jp, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), CFG, device="cpu")


def _prompt(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (B, S)).astype(np.int32)


def _greedy(params, prompt):
    """STEPS greedy tokens from each package's step chain, and the caches
    and position after the last prefill/decode step."""
    jp, tp = params
    jtok, jc = _jprefill(jp, {"tokens": jnp.asarray(prompt)})
    ttok, tc = engine.make_prefill_step(CFG, None, MAX_LEN)(
        tp, {"tokens": torch.from_numpy(prompt).long()})
    assert ttok.dtype == torch.int32 and ttok.shape == (B,)
    jids, tids = [np.asarray(jtok)], [ttok.numpy()]
    decode = engine.make_decode_step(CFG, None)
    for i in range(STEPS - 1):
        pos = np.full((B,), S + i, np.int32)
        jtok, jc = _jdecode(jp, jtok[:, None], jc, jnp.asarray(pos))
        ttok, tc = decode(tp, ttok[:, None].long(), tc,
                          torch.from_numpy(pos).long())
        jids.append(np.asarray(jtok))
        tids.append(ttok.numpy())
    return np.stack(jids, 1), np.stack(tids, 1), (jtok, jc), (ttok, tc)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_chain_matches_jax(params, seed):
    jids, tids, _, _ = _greedy(params, _prompt(seed))
    np.testing.assert_array_equal(tids, jids)


@pytest.mark.parametrize("use_index", [False, True], ids=["dense", "index"])
def test_topk_step_matches_jax_and_greedy(params, use_index):
    jp, tp = params
    jids, tids, (jtok, jc), (ttok, tc) = _greedy(params, _prompt(2))
    pos = np.full((B,), S + STEPS - 1, np.int32)
    head = api.head_table(tp, CFG)
    if use_index:
        jindex = jret.build_index(japi.head_table(jp, JCFG))
        jout = _jtopk(True)(jp, jindex, jtok[:, None], jc, jnp.asarray(pos))
        index = retrieval.build_index(head)
        assert index.num_leaves_shard > 1  # a real descent at full beam
    else:
        jout = _jtopk(False)(jp, jtok[:, None], jc, jnp.asarray(pos))
        index = None
    ids, logits, caches = engine.make_topk_step(CFG, None, K, index=index)(
        tp, ttok[:, None].long(), tc, torch.from_numpy(pos).long())
    assert caches is tc
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jout[0]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jout[1]),
                               rtol=1e-5, atol=1e-5)
    # top-1 of the top-k step is the greedy token of the same step, taken
    # again from the same caches (the step rewrites the same K/V at pos)
    nxt, _ = engine.make_decode_step(CFG, None)(
        tp, ttok[:, None].long(), tc, torch.from_numpy(pos).long())
    np.testing.assert_array_equal(ids[:, 0].numpy(), nxt.numpy())


def test_argmax_island_breaks_ties_to_the_lowest_id():
    head = torch.zeros((6, 4))
    head[[1, 4]] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    h = torch.tensor([[2.0, 0.0, 0.0, 0.0], [-1.0, 0.0, 0.0, 0.0]])
    ids = engine._argmax_island(CFG, None, head, h)
    np.testing.assert_array_equal(ids.numpy(), [1, 0])
    # rows past vocab_size (TP padding) never win
    cfg = CFG.reduced(vocab_size=4)
    head[5] = 10.0
    assert engine._argmax_island(cfg, None, head, h)[0] == 1


def test_encdec_steps_raise():
    """The encoder-decoder family's three steps no longer raise: on
    whisper-large-v3 reduced, the prefill encodes the frames, fills every
    decoder layer's cross K/V and picks the token after token 0; a greedy
    step and a top-k step follow, the greedy token the top-k's first (the
    steps against the reference engine: ``test_torch_encdec.py``)."""
    cfg = get_config("whisper-large-v3").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu", max_len=16)
    frames = torch.randn((B, 10, cfg.d_model),
                         generator=torch.Generator().manual_seed(1))
    tok, cache = engine.make_prefill_step(cfg, None, 16)(
        params, {"frames": frames})
    assert tok.shape == (B,) and tok.dtype == torch.int32
    assert cache["cross_k"].shape == (cfg.n_dec_layers, B, 10,
                                      cfg.n_kv_heads, cfg.resolved_head_dim)
    assert cache["self_k"].shape[2] == 16 and cache["self_k"][:, :, 0].any()
    pos = torch.ones((B,), dtype=torch.long)
    nxt, cache = engine.make_decode_step(cfg, None)(
        params, tok[:, None].long(), cache, pos)
    ids, _, _ = engine.make_topk_step(cfg, None, 2)(
        params, tok[:, None].long(), cache, pos)
    assert ids.shape == (B, 2) and torch.equal(ids[:, 0], nxt)
