"""The decoder LMs' serving engine on a (data, model) mesh under the
reference's ``ctx_for_serve`` (``serve/engine.py``,
``models/transformer.py``, ``models/layers.py``, ``models/mamba.py``,
``serve/quantized_index.py``, ``sharding/rules.py``,
``core/distributed.py``, ``convert.py``, ``api.py``) against the
reference's own serving path.

The reference runs in one subprocess of 8 host devices on
``jax.sharding.Mesh`` meshes built from the device list (Auto axes, so
its ``ShardCtx.act`` constraints place the caches): ``jax.jit`` of
``transformer.prefill`` beside ``engine.make_prefill_step``, and of
``transformer.decode_step`` beside ``engine.make_decode_step`` and the
dense ``engine.decode_topk``, under ``rules.ctx_for_serve`` (mode
``tp``), its parameters placed by ``param_specs_for``; and
``quantized_index.build_quantized_index`` / ``decode_topk`` with that
ctx.  The port runs on gloo ranks (``torch_mesh_util``), each holding its
shards (``convert.lm_shards_from_jax``) and its rows of the batch
(``rules.serve_rows``).  llama3-8b and falcon-mamba-7b ``.reduced()`` at
2 layers in fp32, prompts of 5 tokens, caches of 12 positions (at tp 4 a
rank's range is 3, so the prompt and the three decode steps cross range
boundaries), at (1, 4) and (2, 2); llama also with 13 positions at
(1, 4) (tp does not divide them: the cache whole on every model rank)
and with a batch of 1 at (2, 2) (dp does not divide it: the batch whole
on every data rank).

Held within 1e-5 of each whole tensor's max, ids equal (ties within that
error aside, none at these seeds): prefill's h and first token, every
cache gathered from the ranks (K/V, conv window, state), three decode
steps' h and tokens, the dense top-k; the sharded ``RetrievalIndex`` at
full beam against the dense top-k; the sharded int8 quantized index shard
by shard against the reference's per-shard build (codes, perm, counts
and rows exactly, scales within an ulp, codebooks within 1e-5), and its
decode ids.  Also: ``convert``'s caches and quantized index onto the
shards and back, bitwise; one decode step's collectives against a count
derived from the layer structure; the facade's mesh ``decode_topk``
equal to ``engine.decode_topk``; the ``in_proj`` channel view built once;
the moe, MLA, hybrid and encoder-decoder configs passing the serving
gate, a rank's caches its blocks (their serving is held in
test_torch_mesh_family_serving.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_mesh_experts import _flat, _unflat
from torch_mesh_util import Reference, close, mesh_id, start_meshes

torch.set_num_threads(1)

B, PROMPT, MAX_LEN, DECODE, K = 4, 5, 12, 3, 5
LAYERS = 2
#: (config, mesh, batch, max_len)
CASES = (("llama3-8b", (1, 4), B, MAX_LEN),
         ("llama3-8b", (2, 2), B, MAX_LEN),
         ("falcon-mamba-7b", (1, 4), B, MAX_LEN),
         ("falcon-mamba-7b", (2, 2), B, MAX_LEN),
         ("llama3-8b", (1, 4), B, MAX_LEN + 1),
         ("llama3-8b", (2, 2), 1, MAX_LEN))
MESHES = ((1, 4), (2, 2))
#: the quantized index's knobs (vocab 512: 8 lists of 16 a shard at tp 4)
QKNOBS = dict(codewords=4, codebooks=2, list_size=16, bits=8)
QUERIES = 8


def _qcase(mesh):
    """The case of ``mesh`` whose ranks build the quantized index, serve
    the facade and carry llama's caches across."""
    return next(c for c in CASES if c[1] == mesh and c[0] == "llama3-8b"
                and c[2] == B and c[3] == MAX_LEN)


def case_id(case) -> str:
    name, mesh, b, max_len = case
    return f"{name}-{mesh_id(mesh)}-b{b}-len{max_len}"


def _key(case) -> str:
    name, (dp, tp), b, max_len = case
    return f"{name}:{dp}:{tp}:{b}:{max_len}"


def _cfg(name: str):
    from repro_torch.configs import get_config

    return get_config(name).reduced(n_layers=LAYERS)


def _tree(name: str, tp: int) -> dict:
    """The reference-form tree (numpy) of a config's reduced variant,
    its heads and vocab padded for tp as the reference's ``init_lm`` pads
    them, from a seeded generator."""
    from repro_torch.models import transformer

    gen = torch.Generator().manual_seed(
        34 + tp + 10 * (name == "falcon-mamba-7b"))
    tree = transformer.init_lm(gen, _cfg(name), "cpu", tp=tp)

    def cast(t):
        return t.numpy().copy() if isinstance(t, torch.Tensor) else t

    return _map(cast, tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _inputs() -> dict:
    rng = np.random.default_rng(34)
    inp: dict = {"trees": {}, "tokens": {}}
    for name, (_, tp), b, _ in CASES:
        if (name, tp) not in inp["trees"]:
            inp["trees"][name, tp] = _tree(name, tp)
        if (name, b) not in inp["tokens"]:
            inp["tokens"][name, b] = rng.integers(
                0, _cfg(name).vocab_size, (b, PROMPT)).astype(np.int64)
    d = _cfg("llama3-8b").d_model
    inp["queries"] = rng.normal(size=(QUERIES, d)).astype(np.float32)
    inp["whole caches"] = {
        name: _whole_caches(name, rng) for name in ("llama3-8b",
                                                    "falcon-mamba-7b")}
    return inp


def _whole_caches(name: str, rng) -> list:
    """Random whole caches of B x MAX_LEN in the reference's layout (for
    the conversion round trip)."""
    from repro_torch.models import transformer

    out = []
    for kind, shapes in transformer._cache_shapes(_cfg(name), B, MAX_LEN):
        out.append({k: rng.normal(size=sh).astype(np.float32)
                    for k, sh in shapes.items()})
    return out


def _ref_inputs(inp: dict) -> dict:
    out = {"cases": np.asarray([_key(c) for c in CASES]),
           "queries": inp["queries"],
           "meshes": np.asarray(MESHES),
           "knobs": np.asarray([QKNOBS[k] for k in (
               "codewords", "codebooks", "list_size", "bits")]),
           "layers": np.asarray(LAYERS), "decode": np.asarray(DECODE),
           "k": np.asarray(K),
           "qcases": np.asarray([_key(_qcase(m)) for m in MESHES])}
    for case in CASES:
        key = _key(case)
        name, (_, tp), b, _ = case
        _flat(inp["trees"][name, tp], key, out)
        out[key + "|tokens"] = inp["tokens"][name, b]
    return out


REF_SCRIPT = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.configs import get_config
from repro.models import api, transformer
from repro.serve import engine, quantized_index
from repro.sharding import rules


def unflat(flat, prefix):
    root = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *parts, last = key[len(prefix) + 1:].split("/")
        d = root
        for p in parts:
            d = d.setdefault(p, {})
        d[last] = jnp.asarray(v)

    def fix(d):
        if not isinstance(d, dict):
            return d
        if d and all(k.isdigit() for k in d):
            return [fix(d[str(i)]) for i in range(len(d))]
        return {k: fix(v) for k, v in d.items()}

    return fix(root)


def flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = np.asarray(tree)


def mesh_of(dp, tp):
    return Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))


inp = dict(np.load(sys.argv[1]))
layers, n_dec, k = int(inp["layers"]), int(inp["decode"]), int(inp["k"])
codewords, codebooks, list_size, bits = [int(x) for x in inp["knobs"]]
out = {}
for key in [str(c) for c in inp["cases"]]:
    name, dp, tp, b, max_len = key.split(":")
    dp, tp, b, max_len = int(dp), int(tp), int(b), int(max_len)
    cfg = get_config(name).reduced(n_layers=layers)
    mesh = mesh_of(dp, tp)
    ctx = rules.ctx_for_serve(mesh, cfg)
    params = unflat(inp, key)
    specs = rules.param_specs_for(params, ctx)
    params = jax.tree_util.tree_map(
        lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)),
        params, specs)
    tokens = jnp.asarray(inp[key + "|tokens"]).astype(jnp.int32)
    s = tokens.shape[1]
    step0 = engine.make_prefill_step(cfg, ctx, max_len)
    dstep = engine.make_decode_step(cfg, ctx)

    @jax.jit
    def prefill(p, t):
        h, caches = transformer.prefill(p, t, cfg, ctx, max_len=max_len)
        tok, caches2 = step0(p, {"tokens": t})
        return h, tok, caches2

    @jax.jit
    def decode(p, tok, caches, pos):
        h, _ = transformer.decode_step(p, tok, caches, pos, cfg, ctx)
        nxt, caches = dstep(p, tok, caches, pos)
        ids, logits = engine.decode_topk(cfg, ctx, api.head_table(p, cfg),
                                         h[:, 0], k)
        return h, nxt, caches, ids, logits

    h, tok, caches = prefill(params, tokens)
    out[key + "|prefill h"] = np.asarray(h)
    out[key + "|prefill tok"] = np.asarray(tok)
    flat(jax.tree_util.tree_map(np.asarray, caches), key + "|prefill caches",
         out)
    for i in range(n_dec):
        pos = jnp.full((b,), s + i, jnp.int32)
        h, tok, caches, ids, logits = decode(params, tok[:, None], caches,
                                             pos)
        out[key + f"|decode {i} h"] = np.asarray(h)
        out[key + f"|decode {i} tok"] = np.asarray(tok)
    out[key + "|topk ids"] = np.asarray(ids)
    out[key + "|topk logits"] = np.asarray(logits)
    flat(jax.tree_util.tree_map(np.asarray, caches), key + "|decode caches",
         out)
    if key in [str(c) for c in inp["qcases"]]:
        w = params["head"]["w"]
        idx = jax.jit(lambda w: quantized_index.build_quantized_index(
            w, ctx, codewords=codewords, codebooks=codebooks,
            list_size=list_size, bits=bits, vocab_size=cfg.vocab_size))(w)
        for f in ("c1", "c2", "codes", "cnt", "perm", "rows", "scale"):
            out[f"qidx:{dp}:{tp}|{f}"] = np.asarray(getattr(idx, f))
        q = jax.device_put(jnp.asarray(inp["queries"]),
                           NamedSharding(mesh, P("data", None)))
        ids, logits = jax.jit(lambda q: quantized_index.decode_topk(
            idx, q, k, None, ctx))(q)
        out[f"qidx:{dp}:{tp}|ids"] = np.asarray(ids)
        out[f"qidx:{dp}:{tp}|logits"] = np.asarray(logits)
np.savez(sys.argv[2], **out)
'''


# --- the ranks ---------------------------------------------------------------


def _decode_collectives(cfg, ctx, b_l: int, seq_split: bool) -> dict:
    """One decode step's collectives on a rank (``make_decode_step``),
    from the layer structure: the embedding's vocab-parallel psum; per
    attention layer one all-gather of the q / k / v heads, the softmax
    merge's pmax and psum where the cache's sequence is split, the
    ``wo`` psum; per mamba layer the ``x_proj`` and ``out_proj`` psums;
    per MLP layer its psum; the greedy token's two (B, 1) all-gathers."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer

    tp = ctx.tp
    d, hd, f4 = cfg.d_model, cfg.resolved_head_dim, 4
    nh, nkv = L.padded_heads(cfg, tp)
    kv_c = transformer.cache_kv_heads(cfg, tp)
    want: dict = {}

    def add(op, n_bytes):
        got = want.setdefault(f"{op} model", {"calls": 0, "bytes": 0})
        got["calls"] += 1
        got["bytes"] += n_bytes

    add("all_reduce_sum", b_l * d * f4)
    for kind in cfg.layer_kinds():
        mixer, ffn = kind.split("+")
        if mixer == "attn":
            add("all_gather", b_l * (nh + 2 * nkv) * hd * f4)
            if seq_split:
                add("all_reduce_max", b_l * nh * f4)
                add("all_reduce_sum", b_l * nh * (hd + 1) * f4)
            add("all_reduce_sum", b_l * d * f4)
        else:
            add("all_reduce_sum", b_l * (cfg.dt_rank + 2 * cfg.ssm_state)
                * f4)
            add("all_reduce_sum", b_l * d * f4)
        if ffn == "mlp":
            add("all_reduce_sum", b_l * d * f4)
    add("all_gather", b_l * tp * f4)
    add("all_gather", b_l * tp * f4)
    assert nh % kv_c == 0
    return want


def _case_run(ctx, inp: dict, case) -> dict:
    from repro_torch import api as facade
    from repro_torch import convert
    from repro_torch.core import distributed
    from repro_torch.models import api, transformer
    from repro_torch.serve import engine, quantized_index, retrieval
    from repro_torch.sharding import rules

    name, (_, tp), b, max_len = case
    cfg = _cfg(name)
    model = convert.lm_shards_from_jax(inp["trees"][name, tp], cfg, ctx,
                                       device="cpu")
    tokens = rules.serve_rows(torch.from_numpy(inp["tokens"][name, b]), ctx)
    b_l = tokens.shape[0]
    prefill = engine.make_prefill_step(cfg, ctx, max_len)
    decode = engine.make_decode_step(cfg, ctx, max_len)
    out: dict = {}
    h, _ = transformer.prefill(model, tokens, cfg, ctx, max_len=max_len)
    tok, caches = prefill(model, {"tokens": tokens})
    out["prefill h"], out["prefill tok"] = h.numpy(), tok.numpy()
    out["prefill caches"] = convert.caches_to_jax(caches, cfg, ctx, batch=b,
                                                  max_len=max_len)
    split = "k" in caches[0] and rules.seq_shards(ctx, max_len) > 1
    if split:
        # a rank's range of the sequence is not told from a whole one
        with pytest.raises(ValueError, match="max_len"):
            transformer.decode_step(model, tok[:, None].long(), caches,
                                    torch.full((b_l,), PROMPT), cfg, ctx)
    for i in range(DECODE):
        pos = torch.full((b_l,), PROMPT + i, dtype=torch.long)
        last = tok[:, None].long()
        out[f"decode {i} h"] = transformer.decode_step(
            model, last, caches, pos, cfg, ctx, max_len)[0].numpy()
        if i == DECODE - 1:
            distributed.reset_collective_counts()
            views = len(model.__dict__.get("_serve_in_proj", {}))
            before = caches  # a mamba step returns new states
        tok, caches = decode(model, last, caches, pos)
        out[f"decode {i} tok"] = tok.numpy()
    out["collectives"] = distributed.collective_counts(by_group=True)
    out["views"] = (views, len(model.__dict__.get("_serve_in_proj", {})))
    out["want collectives"] = _decode_collectives(cfg, ctx, b_l, split)
    out["decode caches"] = convert.caches_to_jax(caches, cfg, ctx, batch=b,
                                                 max_len=max_len)
    ids, logits, _ = engine.make_topk_step(cfg, ctx, K, max_len=max_len)(
        model, last, before, pos)
    out["topk"] = (ids.numpy(), logits.numpy())
    head = api.head_table(model, cfg, ctx)
    index = retrieval.build_index(head, ctx, vocab_size=cfg.vocab_size)
    ids, logits, _ = engine.make_topk_step(cfg, ctx, K, index=index,
                                           max_len=max_len)(
        model, last, before, pos)
    out["index topk"] = (ids.numpy(), logits.numpy())
    if case == _qcase(case[1]):
        out["quantized"] = _quantized(ctx, inp, model, head)
        out["drawn"] = _drawn_shards(cfg, ctx)
        q = rules.serve_rows(torch.from_numpy(inp["queries"]), ctx)
        out["facade"] = [
            tuple(x.numpy() for x in fn()) for fn in (
                lambda: facade.SoftmaxHead(cfg).decode_topk(
                    head, q, K, ctx=ctx),
                lambda: engine.decode_topk(cfg, ctx, head, q, K))]
        whole = inp["whole caches"][name]
        mine = convert.caches_from_jax(whole, cfg, device="cpu", ctx=ctx)
        out["caches back"] = convert.caches_to_jax(mine, cfg, ctx, batch=B,
                                                   max_len=MAX_LEN)
        out["caches held"] = [{k: tuple(t.shape) for k, t in c.items()}
                              for c in mine]
    if name == "falcon-mamba-7b":
        whole = inp["whole caches"][name]
        mine = convert.caches_from_jax(whole, cfg, device="cpu", ctx=ctx)
        out["caches back"] = convert.caches_to_jax(mine, cfg, ctx, batch=B,
                                                   max_len=MAX_LEN)
        out["caches held"] = [{k: tuple(t.shape) for k, t in c.items()}
                              for c in mine]
    return out


def _drawn_shards(cfg, ctx) -> dict:
    """Per parameter, whether ``init_lm(..., shard=True)`` in the serve
    mode (``api.init_module``) drew this rank's shard of the whole tree
    the same seed draws, and the spec it set."""
    from repro_torch.models import api, transformer
    from repro_torch.train import step

    drawn = api.init_module(cfg, torch.Generator().manual_seed(5), "cpu",
                            ctx=ctx)
    whole = step.shard_params(transformer.StackedLM(
        cfg, "cpu", tree=transformer.init_lm(
            torch.Generator().manual_seed(5), cfg, "cpu", ctx=ctx)),
        cfg, ctx)
    want = dict(whole.named_parameters())
    return {k: (torch.equal(p, want[k]), drawn.param_specs[k],
                whole.param_specs[k])
            for k, p in drawn.named_parameters()}


def _quantized(ctx, inp: dict, model, head: torch.Tensor) -> dict:
    from repro_torch import convert
    from repro_torch.serve import quantized_index
    from repro_torch.sharding import rules
    from repro_torch.train import step

    cfg = _cfg("llama3-8b")
    idx = quantized_index.build_quantized_index(
        head, ctx, vocab_size=cfg.vocab_size, **QKNOBS)
    q = rules.serve_rows(torch.from_numpy(inp["queries"]), ctx)
    ids, logits = quantized_index.decode_topk(idx, q, K, None, ctx)
    fields = convert.index_to_jax(idx, ctx)
    back = convert.index_to_jax(convert.index_from_jax(
        fields, device="cpu", ctx=ctx), ctx)
    cfg_q = dataclasses.replace(
        cfg, midx_codewords=QKNOBS["codewords"],
        midx_codebooks=QKNOBS["codebooks"], sampler_block=QKNOBS[
            "list_size"], midx_bits=QKNOBS["bits"])
    state = step.TrainState(params=model, opt_state=None,
                            sampler_state=None, step=0)
    exported = convert.index_to_jax(
        step.export_quantized_index(state, cfg_q, ctx), ctx)
    return {"fields": fields, "back": back, "ids": ids.numpy(),
            "logits": logits.numpy(), "exported": exported,
            "recall": quantized_index.recall_at_k(idx, head, q, K, None,
                                                  ctx),
            "shard": (idx.shard_index, idx.tp, tuple(idx.rows.shape))}


def _worker(ctx, inp: dict) -> dict:
    from repro_torch.sharding import rules

    mesh = (ctx.axis_size("data"), ctx.tp)
    return {case: _case_run(rules.ctx_for_serve(ctx.mesh, _cfg(case[0])),
                            inp, case)
            for case in CASES if case[1] == mesh}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's serving results and every mesh's ranks' from the
    same inputs."""
    base = tmp_path_factory.mktemp("mesh_lm_serving")
    inp = _inputs()
    ref = Reference(REF_SCRIPT, _ref_inputs(inp), base)
    started = start_meshes(_worker, base, inp, meshes=MESHES)
    got = ref.result()
    ranks = {mesh: r.result() for mesh, r in started.items()}
    return inp, got, ranks


def _ranks_of(runs, case):
    return runs[2][case[1]]


def _rows(x: np.ndarray, case, rank: int) -> np.ndarray:
    """Rank ``rank``'s rows of a whole batch (``rules.serve_rows``)."""
    _, (dp, tp), b, _ = case
    if b % dp:
        return x
    per = b // dp
    i = rank // tp
    return x[i * per:(i + 1) * per]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_prefill_h_token_and_caches(runs, case):
    """Prefill's h and first token on each rank equal the reference's on
    its rows; every cache leaf gathered from the ranks equals the
    reference's."""
    _, ref, _ = runs
    key = _key(case)
    want_caches = _unflat(ref, key + "|prefill caches")
    for r, res in enumerate(_ranks_of(runs, case)):
        got = res[case]
        close(got["prefill h"], _rows(ref[key + "|prefill h"], case, r),
              what="prefill h")
        np.testing.assert_array_equal(
            got["prefill tok"], _rows(ref[key + "|prefill tok"], case, r))
        _close_caches(got["prefill caches"], want_caches)


def _close_caches(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            close(g[k], w[k], what=k)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_decode_steps_and_dense_topk(runs, case):
    """Three decode steps' h and greedy tokens, the caches after them and
    the dense top-k step equal the reference's."""
    _, ref, _ = runs
    key = _key(case)
    for r, res in enumerate(_ranks_of(runs, case)):
        got = res[case]
        for i in range(DECODE):
            close(got[f"decode {i} h"],
                  _rows(ref[key + f"|decode {i} h"], case, r),
                  what=f"decode {i} h")
            np.testing.assert_array_equal(
                got[f"decode {i} tok"],
                _rows(ref[key + f"|decode {i} tok"], case, r))
        _close_caches(got["decode caches"],
                      _unflat(ref, key + "|decode caches"))
        ids, logits = got["topk"]
        np.testing.assert_array_equal(ids, _rows(ref[key + "|topk ids"],
                                                 case, r))
        close(logits, _rows(ref[key + "|topk logits"], case, r),
              what="top-k logits")


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_sharded_index_full_beam_equals_dense_topk(runs, case):
    """The sharded ``RetrievalIndex`` at full beam, through the engine's
    top-k step, equals the dense top-k."""
    _, ref, _ = runs
    key = _key(case)
    for r, res in enumerate(_ranks_of(runs, case)):
        ids, logits = res[case]["index topk"]
        np.testing.assert_array_equal(ids, _rows(ref[key + "|topk ids"],
                                                 case, r))
        close(logits, _rows(ref[key + "|topk logits"], case, r))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_decode_collectives(runs, case):
    """One decode step's collectives, calls and bytes by op and group,
    equal the count derived from the layer structure; the mamba layers'
    ``in_proj`` channel views were built once, before that step."""
    for res in _ranks_of(runs, case):
        got = res[case]
        assert got["collectives"] == got["want collectives"]
        views = LAYERS if case[0] == "falcon-mamba-7b" and \
            case[1][1] > 1 else 0
        assert got["views"] == (views, views)


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_quantized_index_shards_and_decode(runs, mesh):
    """Each rank's shard of the int8 quantized index equals the
    reference's mesh build's shard (its per-shard ``_build_local``), its
    decode ids and logits the reference's; ``export_quantized_index`` on
    the mesh builds the same index; the index crosses onto each rank and
    back bitwise; the recall at exhaustive beam is the dense top-k's."""
    _, ref, ranks = runs
    dp, tp = mesh
    case = _qcase(mesh)
    pre = f"qidx:{dp}:{tp}|"
    for r, res in enumerate(ranks[mesh]):
        got = res[case]["quantized"]
        assert got["shard"][:2] == (r % tp, tp)
        fields = got["fields"]
        assert (fields["n"], fields["tp"], fields["bits"]) == (512, tp, 8)
        for f in ("codes", "perm", "cnt", "rows"):
            np.testing.assert_array_equal(fields[f], ref[pre + f],
                                          err_msg=f)
        np.testing.assert_allclose(fields["scale"], ref[pre + "scale"],
                                   rtol=2 ** -23, atol=0)
        for f in ("c1", "c2"):
            close(fields[f], ref[pre + f], what=f)
        rows = slice((r // tp) * (QUERIES // dp),
                     (r // tp + 1) * (QUERIES // dp))
        np.testing.assert_array_equal(got["ids"], ref[pre + "ids"][rows])
        close(got["logits"], ref[pre + "logits"][rows])
        for f in ("c1", "c2", "codes", "cnt", "perm", "rows", "scale"):
            np.testing.assert_array_equal(got["back"][f], fields[f])
            np.testing.assert_array_equal(got["exported"][f], fields[f])
        assert got["recall"] > 0.9


@pytest.mark.parametrize("name", ("llama3-8b", "falcon-mamba-7b"))
def test_convert_caches_onto_shards_and_back(runs, name):
    """The reference's whole caches cut onto each rank's blocks (K/V its
    data rows and sequence range, a mamba leaf its data rows and
    channels) and gathered back, bitwise."""
    inp, _, ranks = runs
    whole = inp["whole caches"][name]
    for mesh in MESHES:
        dp, tp = mesh
        case = next(c for c in CASES if c[1] == mesh and c[0] == name
                    and c[2] == B and c[3] == MAX_LEN)
        for res in ranks[mesh]:
            got = res[case]
            for g, w, held in zip(got["caches back"], whole,
                                  got["caches held"]):
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
                    sh = list(w[k].shape)
                    sh[1] //= dp
                    sh[2 if k in ("k", "v", "ssm") else 3] //= tp
                    assert held[k] == tuple(sh), (k, held[k], sh)


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_init_lm_draws_a_serve_ranks_shards(runs, mesh):
    """``init_lm(..., shard=True)`` in the serve mode (tp) draws each
    rank's shards of the tree the same seed draws whole, with the serve
    mode's specs (the feature dims whole: no F in tp)."""
    _, _, ranks = runs
    for res in ranks[mesh]:
        got = res[_qcase(mesh)]["drawn"]
        assert got["embed.table"][1] == ("model", None)
        for name, (same, spec, want) in got.items():
            assert same and spec == want, name
            assert "data" not in spec, name


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_facade_decode_topk_on_the_mesh(runs, mesh):
    """``SoftmaxHead.decode_topk`` on a mesh ctx sends the dense path to
    ``engine.decode_topk``: the same ids and logits."""
    _, _, ranks = runs
    case = _qcase(mesh)
    for res in ranks[mesh]:
        (fi, fl), (ei, el) = res[case]["facade"]
        np.testing.assert_array_equal(fi, ei)
        np.testing.assert_array_equal(fl, el)


class _SizesOnly:
    """What ``rules.ShardCtx`` reads of a mesh before any collective."""

    mesh_dim_names = ("data", "model")

    def __init__(self, dp: int, tp: int):
        self._sizes = (dp, tp)

    def size(self, dim: int) -> int:
        return self._sizes[dim]

    def get_local_rank(self, axis: str) -> int:
        return 0


@pytest.mark.parametrize("name", ("dbrx-132b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b", "whisper-large-v3"))
def test_serve_gate_passes_and_init_cache_holds_blocks(name):
    """The moe, MLA, hybrid and encoder-decoder configs pass the serving
    gate on a serve mesh (the family gate and the engine's three step
    constructors, before any collective), and a (1, 4) rank's caches hold
    its blocks: K/V and MLA's latent rows a quarter of the sequence,
    mamba's window and state a quarter of the channels, the
    encoder-decoder's self and cross K/V a quarter of each sequence
    (``encdec.cache_specs``).  Their serving itself is held in
    test_torch_mesh_family_serving.py."""
    from repro_torch.configs import get_config
    from repro_torch.models import api, encdec, transformer
    from repro_torch.serve import engine
    from repro_torch.sharding import rules

    cfg = get_config(name).reduced()
    ctx = rules.ctx_for_serve(_SizesOnly(1, 4), cfg)
    assert ctx.mode == ("tp_fsdp" if cfg.serve_fsdp else "tp")
    assert api.require_serve_mesh(cfg) is None
    for step in (engine.make_prefill_step(cfg, ctx, 8),
                 engine.make_decode_step(cfg, ctx, 8, frames=12),
                 engine.make_topk_step(cfg, ctx, 2, max_len=8, frames=12)):
        assert callable(step)
    if cfg.family == "encdec":
        specs = encdec.cache_specs(cfg, 2, 8, 12, ctx)
        held = {k: rules.local_shape(sh, specs[k], ctx) for k, sh in
                encdec._cache_shapes(cfg, 2, 8, 12, ctx.tp_backbone).items()}
        assert held["self_k"][2] == 2 and held["cross_v"][2] == 3, held
        return
    caches = transformer.init_cache(cfg, 2, 8, ctx, device="cpu")
    for (kind, count), c in zip(transformer.segments_of(cfg), caches):
        if kind.startswith("attn") and cfg.mla:
            assert c.shape == (count, 2, 2, cfg.kv_lora_rank
                               + cfg.qk_rope_dim)
        elif kind.startswith("attn"):
            assert c["k"].shape[2] == c["v"].shape[2] == 2
        else:
            assert c["conv"].shape[-1] == c["ssm"].shape[-2] == \
                cfg.d_inner // 4


def test_serve_ctx_and_cache_specs():
    """``ctx_for_serve`` picks tp (tp_fsdp where ``serve_fsdp``), and the
    cache specs are the reference's ``init_cache`` constraints fitted:
    the sequence over ``model`` only where tp divides ``max_len``, the
    batch over ``data`` only where dp divides it, mamba's channels over
    ``model``; ``serve_rows`` keeps a batch dp does not divide whole."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.sharding import rules

    llama, falcon = _cfg("llama3-8b"), _cfg("falcon-mamba-7b")
    ctx = rules.ctx_for_serve(_SizesOnly(2, 2), llama)
    assert (ctx.mode, ctx.seq_residuals) == ("tp", False)
    assert rules.ctx_for_serve(_SizesOnly(2, 2), get_config(
        "dbrx-132b")).mode == "tp_fsdp"
    kv = transformer.cache_specs(llama, 4, 12, ctx)[0]["k"]
    assert kv == (None, "data", "model", None, None)
    assert transformer.cache_specs(llama, 1, 13, ctx)[0]["v"] == (
        None, None, None, None, None)
    mamba = transformer.cache_specs(falcon, 4, 12, ctx)[0]
    assert mamba == {"conv": (None, "data", None, "model"),
                     "ssm": (None, "data", "model", None)}
    assert transformer.cache_specs(llama, 4, 12, None)[0]["k"] == (
        None,) * 5
    x = torch.arange(3)
    assert rules.serve_rows(x, ctx) is x
    caches = transformer.init_cache(llama, 4, 12, ctx, device="cpu")
    assert caches[0]["k"].shape == (LAYERS, 2, 6, 2, 16)
    assert rules.seq_shards(ctx, 12) == 2
    whole = transformer.init_cache(llama, 4, 13, ctx, device="cpu")
    assert whole[0]["k"].shape == (LAYERS, 2, 13, 2, 16)
    assert rules.seq_shards(ctx, 13) == 1
    assert rules.seq_shards(None, 12) == 1
