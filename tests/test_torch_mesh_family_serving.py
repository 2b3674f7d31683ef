"""The rest of serving on a (data, model) mesh under the reference's
``ctx_for_serve``: the hybrid family's experts and mamba layers under
``tp``, the moe family and MLA's sequence-sharded latent cache under
``serve_fsdp`` (tp_fsdp), and the encoder-decoder's self and cross
caches (``serve/engine.py``, ``models/transformer.py``,
``models/moe.py``, ``models/mla.py``, ``models/layers.py``,
``models/encdec.py``, ``sharding/rules.py``, ``convert.py``) against the
reference's own serving path.

The reference runs in one subprocess of 8 host devices on
``jax.sharding.Mesh`` meshes built from the device list (Auto axes, so
its ``ShardCtx.act`` constraints place the caches and its MoE
``shard_map`` runs): ``jax.jit`` of ``transformer.prefill`` /
``decode_step`` (or ``encdec.encode``, ``init_dec_cache`` and
``decode_step``) beside the engine's prefill and decode steps and the
dense ``engine.decode_topk``, under ``rules.ctx_for_serve``, its
parameters placed by ``param_specs_for``.  Its MoE dispatch is wrapped
in the subprocess so that each device's drops on its experts reach the
host through ``jax.debug.callback``.  The port runs on gloo ranks
(``torch_mesh_util``), each holding its shards
(``convert.lm_shards_from_jax``) and its rows of the batch
(``rules.serve_rows``).  Each config is ``.reduced()`` in fp32:

  * jamba-v0.1-52b at 3 layers, its attention moved to offset 2 (mamba +
    MLP, mamba + MoE, attention + MLP), tp mode;
  * dbrx-132b at 2 layers with a capacity factor of 0.5 (assignments
    drop at prefill), tp_fsdp (its F leaves gathered over ``data`` per
    layer);
  * deepseek-v3-671b at 2 layers (a dense MLA layer, an MLA + MoE layer
    with the sigmoid router and the shared expert), tp_fsdp;
  * whisper-large-v3 at 2 + 2 layers, vocab 510 (padded to 512 at tp 4),
    12 frames (3 a rank at tp 4), tp mode;

each at (1, 4) and (2, 2), prompts of 5 tokens and caches of 12
positions; deepseek also with 13 positions at (1, 4) (tp does not divide
them: the latent cache whole on every model rank, no merge), and dbrx
with a batch of 1 at (2, 2) (the tokens whole on every data rank, the
MoE's capacity from the whole batch).

Held within 1e-5 of each whole tensor's max, ids equal (ties within that
error aside, none at these seeds): prefill's h and first token, every
cache gathered from the ranks (K/V, latent rows, conv window, state,
self and cross K/V), three decode steps' h and tokens, the dense top-k;
the sharded ``RetrievalIndex`` at full beam against the dense top-k; the
MoE's drops over the ranks equal to the reference's over its devices.
Also: ``convert``'s latent and encoder-decoder caches onto the shards
and back, bitwise; one decode step's collectives, by op and group, in
calls and bytes, against a count derived from the layer structure;
``init_lm(..., shard=True)`` drawing a tp_fsdp serving rank's shards.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from test_torch_mesh_experts import _flat, _unflat
from torch_mesh_util import Reference, close, mesh_id, start_meshes

torch.set_num_threads(1)

B, PROMPT, MAX_LEN, DECODE, K, FRAMES = 4, 5, 12, 3, 5, 12
#: each config's changes to ``.reduced()``
OVERRIDES = {
    "jamba-v0.1-52b": dict(n_layers=3, attn_layer_offset=2),
    "dbrx-132b": dict(n_layers=2, capacity_factor=0.5),
    "deepseek-v3-671b": dict(n_layers=2),
    "whisper-large-v3": dict(vocab_size=510)}
#: (config, mesh, batch, max_len)
CASES = (("jamba-v0.1-52b", (1, 4), B, MAX_LEN),
         ("jamba-v0.1-52b", (2, 2), B, MAX_LEN),
         ("dbrx-132b", (1, 4), B, MAX_LEN),
         ("dbrx-132b", (2, 2), B, MAX_LEN),
         ("deepseek-v3-671b", (1, 4), B, MAX_LEN),
         ("deepseek-v3-671b", (2, 2), B, MAX_LEN),
         ("whisper-large-v3", (1, 4), B, MAX_LEN),
         ("whisper-large-v3", (2, 2), B, MAX_LEN),
         ("deepseek-v3-671b", (1, 4), B, MAX_LEN + 1),
         ("dbrx-132b", (2, 2), 1, MAX_LEN))
MESHES = ((1, 4), (2, 2))
#: the configs whose whole caches cross onto the shards and back
CONVERTED = ("deepseek-v3-671b", "whisper-large-v3")


def case_id(case) -> str:
    name, mesh, b, max_len = case
    return f"{name}-{mesh_id(mesh)}-b{b}-len{max_len}"


def _key(case) -> str:
    name, (dp, tp), b, max_len = case
    return f"{name}:{dp}:{tp}:{b}:{max_len}"


def _cfg(name: str):
    from repro_torch.configs import get_config

    return get_config(name).reduced(**OVERRIDES[name])


def _tree(name: str, tp: int) -> dict:
    """The reference-form tree (numpy) of a config's variant, its heads
    and vocab padded for tp as the reference's ``init_lm`` /
    ``init_encdec`` pad them (position tables of 16 rows), from a seeded
    generator."""
    from repro_torch.models import encdec, transformer

    cfg = _cfg(name)
    gen = torch.Generator().manual_seed(35 + tp + 10 * len(name))
    if cfg.family == "encdec":
        tree = encdec.init_encdec(gen, cfg, "cpu", tp=tp, max_len=16)
    else:
        tree = transformer.init_lm(gen, cfg, "cpu", tp=tp)
    return _numpy(tree)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy().copy()


def _inputs() -> dict:
    rng = np.random.default_rng(35)
    inp: dict = {"trees": {}, "prompts": {}, "cases": CASES}
    for name, (_, tp), b, _ in CASES:
        cfg = _cfg(name)
        if (name, tp) not in inp["trees"]:
            inp["trees"][name, tp] = _tree(name, tp)
        if (name, b) not in inp["prompts"]:
            inp["prompts"][name, b] = (
                rng.normal(size=(b, FRAMES, cfg.d_model)).astype(np.float32)
                if cfg.family == "encdec" else
                rng.integers(0, cfg.vocab_size, (b, PROMPT)).astype(np.int64))
    inp["whole caches"] = {name: _whole_caches(name, rng)
                           for name in CONVERTED}
    return inp


def _whole_caches(name: str, rng):
    """Random whole caches of B x MAX_LEN (and FRAMES) in the reference's
    layout: deepseek's latent rows per segment, whisper's four leaves."""
    from repro_torch.models import encdec, transformer

    cfg = _cfg(name)
    if cfg.family == "encdec":
        return {k: rng.normal(size=sh).astype(np.float32) for k, sh in
                encdec._cache_shapes(cfg, B, MAX_LEN, FRAMES).items()}
    return [rng.normal(size=shape).astype(np.float32)
            for _, shape in transformer._cache_shapes(cfg, B, MAX_LEN)]


def _ref_inputs(inp: dict) -> dict:
    out = {"cases": np.asarray([_key(c) for c in CASES]),
           "overrides": np.asarray(json.dumps(OVERRIDES)),
           "decode": np.asarray(DECODE), "k": np.asarray(K)}
    for case in CASES:
        key = _key(case)
        name, (_, tp), b, _ = case
        _flat(inp["trees"][name, tp], key, out)
        out[key + "|prompt"] = inp["prompts"][name, b]
    return out


REF_SCRIPT = r'''
import json
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding

from repro.configs import get_config
from repro.models import api, encdec, moe, transformer
from repro.serve import engine
from repro.sharding import rules

# each device's drops on its experts, per MoE dispatch, to the host
DROPS = []
_dcc = moe._dispatch_compute_combine


def dcc(x2d, ids, w, wg, wu, wd, cfg, e_lo, e_l, capacity):
    flat = ids.reshape(-1)
    mine = (flat >= e_lo) & (flat < e_lo + e_l)
    onehot = jax.nn.one_hot(flat, cfg.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    jax.debug.callback(lambda n: DROPS.append(int(n)),
                       jnp.sum(mine & (pos >= capacity)))
    return _dcc(x2d, ids, w, wg, wu, wd, cfg, e_lo, e_l, capacity)


moe._dispatch_compute_combine = dcc


def drops():
    jax.effects_barrier()
    n = sum(DROPS)
    DROPS.clear()
    return np.asarray(n)


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
overrides = json.loads(str(inp["overrides"]))
n_dec, k = int(inp["decode"]), int(inp["k"])
out = {}
for key in [str(c) for c in inp["cases"]]:
    name, dp, tp, b, max_len = key.split(":")
    dp, tp, b, max_len = int(dp), int(tp), int(b), int(max_len)
    cfg = get_config(name).reduced(**overrides[name])
    mesh = mesh_of(dp, tp)
    ctx = rules.ctx_for_serve(mesh, cfg)
    params = unflat(inp, key)
    specs = rules.param_specs_for(params, ctx)
    params = jax.tree_util.tree_map(
        lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)),
        params, specs)
    prompt = jnp.asarray(inp[key + "|prompt"])
    step0 = engine.make_prefill_step(cfg, ctx, max_len)
    dstep = engine.make_decode_step(cfg, ctx)

    if cfg.family == "encdec":
        def hidden(p, tok, caches, pos):
            return encdec.decode_step(p, tok, caches, pos, cfg, ctx)[0]

        @jax.jit
        def prefill(p, frames):
            enc = encdec.encode(p, frames, cfg, ctx)
            caches = encdec.init_dec_cache(p, cfg, b, max_len, enc, ctx)
            zero = jnp.zeros((b,), jnp.int32)
            h = hidden(p, zero[:, None], caches, zero)
            tok, caches2 = step0(p, {"frames": frames})
            return h, tok, caches2
        s = 1
    else:
        prompt = prompt.astype(jnp.int32)

        def hidden(p, tok, caches, pos):
            return transformer.decode_step(p, tok, caches, pos, cfg, ctx)[0]

        @jax.jit
        def prefill(p, t):
            h, _ = transformer.prefill(p, t, cfg, ctx, max_len=max_len)
            tok, caches2 = step0(p, {"tokens": t})
            return h, tok, caches2
        s = prompt.shape[1]

    @jax.jit
    def decode(p, tok, caches, pos):
        h = hidden(p, tok, caches, pos)
        nxt, caches = dstep(p, tok, caches, pos)
        ids, logits = engine.decode_topk(cfg, ctx, api.head_table(p, cfg),
                                         h[:, 0], k)
        return h, nxt, caches, ids, logits

    h, tok, caches = prefill(params, prompt)
    out[key + "|prefill h"] = np.asarray(h)
    out[key + "|prefill tok"] = np.asarray(tok)
    out[key + "|prefill drops"] = drops()
    flat(jax.tree_util.tree_map(np.asarray, caches), key + "|prefill caches",
         out)
    for i in range(n_dec):
        pos = jnp.full((b,), s + i, jnp.int32)
        h, tok, caches, ids, logits = decode(params, tok[:, None], caches,
                                             pos)
        out[key + f"|decode {i} h"] = np.asarray(h)
        out[key + f"|decode {i} tok"] = np.asarray(tok)
        out[key + f"|decode {i} drops"] = drops()
    out[key + "|topk ids"] = np.asarray(ids)
    out[key + "|topk logits"] = np.asarray(logits)
    flat(jax.tree_util.tree_map(np.asarray, caches), key + "|decode caches",
         out)
np.savez(sys.argv[2], **out)
'''


# --- the ranks ---------------------------------------------------------------


class _Drops:
    """The port's MoE drops on this rank's experts, per dispatch
    (``moe._dispatch_compute_combine`` wrapped while on)."""

    def __init__(self):
        from repro_torch.models import moe

        self.n, self._moe = 0, moe
        self._dcc = moe._dispatch_compute_combine

        def dcc(x2d, ids, w, wg, wu, wd, cfg, cap, e_lo=0):
            self.n += moe.dropped(ids, cfg, cap, e_lo, wg.shape[0])
            return self._dcc(x2d, ids, w, wg, wu, wd, cfg, cap, e_lo)

        moe._dispatch_compute_combine = dcc

    def take(self) -> int:
        n, self.n = self.n, 0
        return n

    def close(self) -> None:
        self._moe._dispatch_compute_combine = self._dcc


def _decode_collectives(model, cfg, ctx, b_l: int, split: dict) -> dict:
    """One decode step's collectives on a rank (``make_decode_step``),
    from the layer structure: in tp_fsdp at dp > 1 one all-gather over
    ``data`` of each F-sharded leaf a step computes with (the embedding,
    every layer's, the head's feature dim); the embedding's
    vocab-parallel psum; per GQA attention layer one all-gather of the q
    / k / v heads, the softmax merge's pmax and psum where the cache's
    sequence is split (``split["self"]``), the ``wo`` psum; per MLA layer,
    where the latent cache's sequence is split, one all-gather of the
    absorbed queries ``[q_lat | q_rope]`` and the merge over the latent
    width, then the ``wo`` psum; per encoder-decoder cross attention the
    merge alone where its frames are split (``split["cross"]``), no
    gather and no psum; per mamba layer the ``x_proj`` and ``out_proj``
    psums; per MLP or MoE layer its one psum (the shared expert's part
    inside it), and in tp mode at dp > 1 the MoE's all-gather of the
    tokens over ``data`` (the reference's tp-mode layer routes every data
    block's tokens); the greedy token's two (B, 1) all-gathers."""
    from repro_torch.models import layers as L
    from repro_torch.models import mla, moe

    tp, f4 = ctx.tp, 4
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = L.padded_heads(cfg, tp)
    want: dict = {}

    def add(op, group, n_bytes):
        got = want.setdefault(f"{op} {group}", {"calls": 0, "bytes": 0})
        got["calls"] += 1
        got["bytes"] += n_bytes

    def merge(heads, width):
        add("all_reduce_max", "model", b_l * heads * f4)
        add("all_reduce_sum", "model", b_l * heads * (width + 1) * f4)

    if ctx.axis_size("data") > 1:
        for name, p in model.named_parameters():
            spec = model.param_specs[name]
            if "data" in spec and not name.startswith("mtp."):
                add("all_gather", "data", p.numel() * ctx.dp * f4)
    add("all_reduce_sum", "model", b_l * d * f4)
    if cfg.family == "encdec":
        kinds = ["self+cross+mlp"] * cfg.n_dec_layers
    else:
        kinds = cfg.layer_kinds()
    for kind in kinds:
        mixer, *_, ffn = kind.split("+")
        if mixer == "attn" and cfg.mla:
            nh_m = mla._dims(cfg, tp)[0]
            width = cfg.kv_lora_rank + cfg.qk_rope_dim
            if split["self"]:
                add("all_gather", "model", b_l * nh_m * width * f4)
                merge(nh_m, cfg.kv_lora_rank)
            add("all_reduce_sum", "model", b_l * d * f4)
        elif mixer in ("attn", "self"):
            add("all_gather", "model", b_l * (nh + 2 * nkv) * hd * f4)
            if split["self"]:
                merge(nh, hd)
            add("all_reduce_sum", "model", b_l * d * f4)
        else:
            add("all_reduce_sum", "model",
                b_l * (cfg.dt_rank + 2 * cfg.ssm_state) * f4)
            add("all_reduce_sum", "model", b_l * d * f4)
        if "cross" in kind and split["cross"]:
            merge(nh, hd)
        if ffn == "moe" and moe.moe_rows(ctx, b_l, None):
            add("all_gather", "data", ctx.dp * b_l * d * f4)
        if ffn in ("mlp", "moe"):
            add("all_reduce_sum", "model", b_l * d * f4)
    add("all_gather", "model", b_l * tp * f4)
    add("all_gather", "model", b_l * tp * f4)
    return want


def _case_run(ctx, inp: dict, case) -> dict:
    from repro_torch import convert
    from repro_torch.core import distributed
    from repro_torch.models import api, encdec, transformer
    from repro_torch.serve import engine, retrieval
    from repro_torch.sharding import rules

    name, (_, tp), b, max_len = case
    cfg = _cfg(name)
    model = convert.lm_shards_from_jax(inp["trees"][name, tp], cfg, ctx,
                                       device="cpu")
    prompt = rules.serve_rows(torch.from_numpy(inp["prompts"][name, b]),
                              ctx)
    b_l = prompt.shape[0]
    encdec_ = cfg.family == "encdec"
    frames = FRAMES if encdec_ else None
    prefill = engine.make_prefill_step(cfg, ctx, max_len)
    decode = engine.make_decode_step(cfg, ctx, max_len, frames=frames)
    probe = _Drops()
    out: dict = {}
    if encdec_:
        enc = encdec.encode(model, prompt, cfg, ctx)
        caches = encdec.init_dec_cache(model, cfg, b, max_len, enc, ctx)
        zero = torch.zeros((b_l,), dtype=torch.long)
        h = encdec.decode_step(model, zero[:, None], caches, zero, cfg, ctx,
                               max_len, FRAMES)[0]
        tok, caches = prefill(model, {"frames": prompt})
        s = 1
    else:
        h, _ = transformer.prefill(model, prompt, cfg, ctx, max_len=max_len)
        tok, caches = prefill(model, {"tokens": prompt})
        s = PROMPT
    out["prefill drops"] = probe.take()
    out["prefill h"], out["prefill tok"] = h.numpy(), tok.numpy()
    out["prefill caches"] = convert.caches_to_jax(
        caches, cfg, ctx, batch=b, max_len=max_len, frames=frames)
    for i in range(DECODE):
        pos = torch.full((b_l,), s + i, dtype=torch.long)
        last = tok[:, None].long()
        if encdec_:
            h = encdec.decode_step(model, last, caches, pos, cfg, ctx,
                                   max_len, FRAMES)[0]
        else:
            h = transformer.decode_step(model, last, caches, pos, cfg, ctx,
                                        max_len)[0]
        out[f"decode {i} h"] = h.numpy()
        if i == DECODE - 1:
            distributed.reset_collective_counts()
            before = caches  # a mamba step returns new states
        tok, caches = decode(model, last, caches, pos)
        if i == DECODE - 1:
            out["collectives"] = distributed.collective_counts(
                by_group=True)
        # the step for h and the engine's step, as the reference runs both
        out[f"decode {i} drops"] = probe.take()
        out[f"decode {i} tok"] = tok.numpy()
    probe.close()
    split = {"self": tp > 1 and rules.seq_shards(ctx, max_len) > 1,
             "cross": tp > 1 and rules.seq_shards(ctx, FRAMES) > 1}
    out["want collectives"] = _decode_collectives(model, cfg, ctx, b_l,
                                                  split)
    out["decode caches"] = convert.caches_to_jax(
        caches, cfg, ctx, batch=b, max_len=max_len, frames=frames)
    topk = engine.make_topk_step(cfg, ctx, K, max_len=max_len, frames=frames)
    ids, logits, _ = topk(model, last, before, pos)
    out["topk"] = (ids.numpy(), logits.numpy())
    head = api.head_table(model, cfg, ctx)
    index = retrieval.build_index(head, ctx, vocab_size=cfg.vocab_size)
    ids, logits, _ = engine.make_topk_step(
        cfg, ctx, K, index=index, max_len=max_len, frames=frames)(
        model, last, before, pos)
    out["index topk"] = (ids.numpy(), logits.numpy())
    if name in CONVERTED and b == B and max_len == MAX_LEN:
        whole = inp["whole caches"][name]
        mine = convert.caches_from_jax(whole, cfg, device="cpu", ctx=ctx)
        out["caches back"] = convert.caches_to_jax(
            mine, cfg, ctx, batch=B, max_len=MAX_LEN, frames=FRAMES)
        out["caches held"] = _shapes(mine)
    if name == "dbrx-132b" and b == B:
        out["drawn"] = _drawn_shards(cfg, ctx)
    return out


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def _drawn_shards(cfg, ctx) -> dict:
    """Per parameter, whether ``init_lm(..., shard=True)`` in the serve
    mode (tp_fsdp here; ``api.init_module``) drew this rank's shard of the
    whole tree the same seed draws, and the spec it set."""
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


def _worker(ctx, inp: dict) -> dict:
    from repro_torch.sharding import rules

    mesh = (ctx.axis_size("data"), ctx.tp)
    return {case: _case_run(rules.ctx_for_serve(ctx.mesh, _cfg(case[0])),
                            inp, case)
            for case in inp["cases"] if case[1] == mesh}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's serving results and every mesh's ranks' from the
    same inputs."""
    base = tmp_path_factory.mktemp("mesh_family_serving")
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


def _close_caches(got, want, exact: bool = False) -> None:
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_caches(got[k], want[k], exact)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_caches(g, w, exact)
    elif exact:
        np.testing.assert_array_equal(got, want)
    else:
        close(got, want)


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


@pytest.mark.parametrize("case", [c for c in CASES
                                  if _cfg(c[0]).n_experts], ids=case_id)
def test_moe_drops_equal_the_reference(runs, case):
    """The MoE's drops, summed over the ranks (each its own experts), at
    the prefill and each decode step equal the reference's summed over
    its devices; dbrx's capacity factor of 0.5 drops at prefill."""
    _, ref, _ = runs
    key = _key(case)
    for phase in ["prefill"] + [f"decode {i}" for i in range(DECODE)]:
        got = sum(res[case][f"{phase} drops"] for res in _ranks_of(runs,
                                                                   case))
        assert got == int(ref[key + f"|{phase} drops"]), phase
    if case[0] == "dbrx-132b":
        assert int(ref[key + "|prefill drops"]) > 0


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_decode_collectives(runs, case):
    """One decode step's collectives, calls and bytes by op and group,
    equal the count derived from the layer structure: the MoE's one
    reduction, MLA's one gather plus its merge, whisper's cross merge with
    no gather, tp_fsdp's data gathers."""
    for res in _ranks_of(runs, case):
        got = res[case]
        assert got["collectives"] == got["want collectives"]
    name, (dp, _), _, max_len = case
    want = _ranks_of(runs, case)[0][case]["want collectives"]
    if _cfg(name).serve_fsdp and dp > 1:
        assert "all_gather data" in want
    if name == "deepseek-v3-671b":
        assert ("all_reduce_max model" in want) == (max_len == MAX_LEN)


@pytest.mark.parametrize("name", CONVERTED)
def test_convert_caches_onto_shards_and_back(runs, name):
    """The reference's whole caches cut onto each rank's blocks (latent
    rows and K/V their data rows and sequence range) and gathered back,
    bitwise."""
    inp, _, ranks = runs
    whole = inp["whole caches"][name]
    for mesh in MESHES:
        dp, tp = mesh
        case = (name, mesh, B, MAX_LEN)
        for res in ranks[mesh]:
            got = res[case]
            _close_caches(got["caches back"], whole, exact=True)
            held = got["caches held"]
            wants = whole.items() if isinstance(whole, dict) \
                else enumerate(whole)
            for k, w in wants:
                sh = list(w.shape)
                sh[1] //= dp
                sh[2] //= tp
                assert held[k] == tuple(sh), (k, held[k], sh)


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_init_lm_draws_a_tp_fsdp_serve_ranks_shards(runs, mesh):
    """``init_lm(..., shard=True)`` in dbrx's serve mode (tp_fsdp) draws
    each rank's shards of the tree the same seed draws whole, with that
    mode's specs (the F and Fd dims over ``data``)."""
    _, _, ranks = runs
    for res in ranks[mesh]:
        got = res[("dbrx-132b", mesh, B, MAX_LEN)]["drawn"]
        assert got["segments.0.0.moe.w_gate"][1] == ("model", "data", None)
        for name, (same, spec, want) in got.items():
            assert same and spec == want, name


class _SizesOnly:
    """What ``rules.ShardCtx`` reads of a mesh before any collective."""

    mesh_dim_names = ("data", "model")

    def __init__(self, dp: int, tp: int):
        self._sizes = (dp, tp)

    def size(self, dim: int) -> int:
        return self._sizes[dim]

    def get_local_rank(self, axis: str) -> int:
        return 0


def test_decode_needs_whole_lengths_at_tp_over_one():
    """On a mesh at tp > 1 the encoder-decoder's step and the LM's take
    their caches' whole lengths (``max_len``, ``frames``): a rank's range
    is not told from a whole sequence by its length."""
    from repro_torch.sharding import rules

    ctx = rules.ShardCtx(mesh=_SizesOnly(1, 4), mode="tp")
    assert rules.seq_split(ctx, 3, 12, "x") == 4
    assert rules.seq_split(ctx, 13, 13, "x") == 1
    with pytest.raises(ValueError, match="frames="):
        rules.seq_split(ctx, 3, None, "caches (frames=)")
    with pytest.raises(ValueError, match="block"):
        rules.seq_split(ctx, 4, 12, "x")
