"""The port's vocab-sharded serving (``serve/retrieval.py``,
``serve/engine.py``, ``convert.py``) on (data, model) meshes of (1, 2),
(2, 2) and (1, 4), gloo ranks (``torch_mesh_util``).

  * the sharded index's arrays, shard by shard, against the reference's
    ``_build_local`` on that shard's rows (here, on one host device: the
    reference's mesh build runs exactly that per shard): the permutation,
    counts and leaf table exactly, the Gram sums, centroids and radii in
    fp32 within 1e-5, the eigenvalues within 1e-4 as the unsharded index
    test holds them, eigenvectors by their sign-free bound;
  * ``decode_topk`` at full beam equal to ``sharded_logits_topk`` and to
    the dense top-k, at vocab 250 (the last shard padded: its padding rows
    never returned), a narrow beam never returning padding;
  * the engine's top-k: youtube-dnn's ``decode_topk`` / ``make_decode_fn``
    both paths, and llama3-8b's prefill, decode and top-k steps (dense and
    index) against the unsharded engine on the same weights, each rank
    holding its shards of them under ``rules.ctx_for_serve`` (8 / 4 heads,
    so no tp of these meshes pads a head: the same weights on every mesh);
  * ``convert.py`` both ways: the port's sharded index gathered as the
    reference's fields, and the reference's fields crossing onto each
    rank (its own shard), decoded on the mesh and gathered back; a
    sharded index off its mesh refused.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_mesh_util import MESHES, close, mesh_id, start_meshes

torch.set_num_threads(1)

VOCAB, WIDTH, LEAF, T, K = 250, 16, 8, 12, 5
LM_VOCAB, LM_BATCH, LM_PROMPT, LM_MAX = 500, 2, 6, 12
FIELDS = ("z", "cnt", "wq", "mu", "rad", "evecs", "evals", "perm")


def _inputs() -> dict:
    rng = np.random.default_rng(53)
    return {"w": (rng.normal(size=(VOCAB, WIDTH)) * 0.4).astype(np.float32),
            "h": rng.normal(size=(T, WIDTH)).astype(np.float32),
            "tokens": rng.integers(0, LM_VOCAB, size=(
                LM_BATCH * 2, LM_PROMPT)).astype(np.int64)}


def _lm_cfg():
    from repro_torch.configs import get_config

    return get_config("llama3-8b").reduced(vocab_size=LM_VOCAB, n_heads=8,
                                           n_kv_heads=4)


def _lm_params():
    from repro_torch.models import api

    return api.init_params(_lm_cfg(), torch.Generator().manual_seed(2),
                           device="cpu")


def _lm_serve(params, ctx, tokens: torch.Tensor, index=None) -> dict:
    """Prefill, one greedy decode step and one top-k step (dense, and
    through ``index`` when given), each from a fresh prefill."""
    from repro_torch.serve import engine

    cfg = _lm_cfg()
    prefill = engine.make_prefill_step(cfg, ctx, LM_MAX)
    pos = torch.full((tokens.shape[0],), LM_PROMPT, dtype=torch.long)
    tok, caches = prefill(params, {"tokens": tokens})
    nxt, _ = engine.make_decode_step(cfg, ctx, LM_MAX)(
        params, tok[:, None].long(), caches, pos)
    out = {"prefill": tok.numpy(), "decode": nxt.numpy()}
    paths = {"dense": None, **({"index": index} if index is not None
                               else {})}
    for tag, idx in paths.items():
        tok, caches = prefill(params, {"tokens": tokens})
        ids, logits, _ = engine.make_topk_step(cfg, ctx, K, index=idx,
                                               max_len=LM_MAX)(
            params, tok[:, None].long(), caches, pos)
        out[tag] = (ids.numpy(), logits.numpy())
    return out


def _serve_worker(ctx, inp: dict) -> dict:
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import distributed
    from repro_torch.serve import engine, retrieval
    from repro_torch.sharding import rules

    tt = torch.from_numpy
    w_l = rules.shard_rows(tt(inp["w"]), ctx)
    h_l = rules.batch_rows(tt(inp["h"]), ctx)
    index = retrieval.build_index(w_l, ctx, leaf_size=LEAF,
                                  vocab_size=VOCAB)
    out: dict = {"fields": convert.index_to_jax(index, ctx),
                 "held": {f: tuple(getattr(index, f).shape)
                          for f in FIELDS}}
    out["stats"] = retrieval.index_stats(index, ctx.model_index).n_valid
    out["beam"] = retrieval.decode_topk(index, h_l, K, None, ctx)
    out["narrow"] = retrieval.decode_topk(index, h_l, K, 2, ctx)
    n_valid = rules.local_n_valid(VOCAB, w_l.shape[0], ctx.model_index)
    bias = torch.where(torch.arange(w_l.shape[0]) < n_valid, 0.0, -torch.inf)
    out["dense"] = distributed.sharded_logits_topk(
        w_l, h_l, K, group=ctx.model_group, bias_local=bias)
    cfg = get_config("youtube-dnn").reduced(vocab_size=VOCAB)
    decode = engine.make_decode_fn(cfg, ctx, w_l, K)
    out["engine"] = {"dense": engine.decode_topk(cfg, ctx, w_l, h_l, K),
                     "index": engine.decode_topk(cfg, ctx, w_l, h_l, K,
                                                 index=index),
                     "fn_dense": decode(None, h_l),
                     "fn_index": decode(index, h_l)}
    mine = convert.index_from_jax(inp[f"ref_{ctx.tp}"], device="cpu",
                                  ctx=ctx)
    out["from_ref"] = retrieval.decode_topk(mine, h_l, K, None, ctx)
    out["ref_back"] = convert.index_to_jax(mine, ctx)
    out["refused"] = []
    for call in (lambda: retrieval.decode_topk(index, h_l, K),
                 lambda: convert.index_to_jax(index)):
        try:
            call()
        except ValueError as e:
            out["refused"].append(str(e))

    from repro_torch.models import api, transformer
    from repro_torch.train import step

    lm_cfg = _lm_cfg()
    sctx = rules.ctx_for_serve(ctx.mesh, lm_cfg)
    model = step.shard_params(transformer.StackedLM(
        lm_cfg, "cpu", tree=_lm_params()), lm_cfg, sctx)
    lm_index = retrieval.build_index(api.head_table(model, lm_cfg, sctx),
                                     sctx, vocab_size=LM_VOCAB)
    out["lm"] = _lm_serve(model, sctx, rules.batch_rows(
        tt(inp["tokens"]), ctx), lm_index)
    return out


def _numpy_out(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_numpy_out(v) for v in x)
    if isinstance(x, dict):
        return {k: _numpy_out(v) for k, v in x.items()}
    return x


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's per-shard builds (here, one device), the unsharded
    engine's results and each mesh's ranks' results."""
    import functools

    import jax
    import jax.numpy as jnp

    from repro.serve import retrieval as jret
    from repro_torch.sharding import rules

    inp = _inputs()
    build = jax.jit(functools.partial(jret._build_local, leaf=LEAF,
                                      cluster=True))
    ref: dict = {}
    for tp in sorted({tp for _, tp in MESHES}):
        v_l = rules.vocab_shard(VOCAB, tp)
        w_pad = np.concatenate([inp["w"], np.zeros(
            (tp * v_l - VOCAB, WIDTH), np.float32)])
        shards = [[np.asarray(a) for a in build(
            jnp.asarray(w_pad[j * v_l:(j + 1) * v_l]),
            n_valid=jnp.int32(rules.local_n_valid(VOCAB, v_l, j)))]
            for j in range(tp)]
        ref[tp] = shards
        inp[f"ref_{tp}"] = {**{f: np.concatenate([s[i] for s in shards])
                               for i, f in enumerate(FIELDS)},
                            "n": VOCAB, "tp": tp, "v_shard": v_l}
    started = start_meshes(_serve_worker, tmp_path_factory.mktemp("serve"),
                           inp)
    lm = _lm_serve(_lm_params(), None, torch.from_numpy(inp["tokens"]))
    ranks = {mesh: [_numpy_out(r) for r in s.result()]
             for mesh, s in started.items()}
    return inp, ref, lm, ranks


def _dense_topk(inp, rows) -> tuple:
    logits = inp["h"][rows] @ inp["w"].T
    ids = np.argsort(-logits, axis=-1, kind="stable")[:, :K]
    return ids, np.take_along_axis(logits, ids, axis=-1)


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_sharded_index_matches_build_local(runs, mesh):
    inp, ref, _, ranks = runs
    dp, tp = mesh
    h = np.random.default_rng(1).normal(size=(4, WIDTH))
    for r, res in enumerate(ranks[mesh]):
        f = res["fields"]
        assert (f["n"], f["tp"], f["v_shard"]) == (
            VOCAB, tp, -(-VOCAB // tp))
        for j in range(tp):
            want = dict(zip(FIELDS, ref[tp][j]))
            got = {k: np.split(f[k], tp)[j] for k in FIELDS}
            for k in ("perm", "cnt", "wq"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            for k in ("z", "mu", "rad"):
                close(got[k], want[k], what=f"{k} shard {j}")
            np.testing.assert_allclose(got["evals"], want["evals"],
                                       rtol=1e-4, atol=1e-5)
            lam = want["evals"][:, :-1]
            bt = np.einsum("ns,tns->tn", lam, np.einsum(
                "nsr,tr->tns", got["evecs"], h) ** 2)
            bj = np.einsum("ns,tns->tn", lam, np.einsum(
                "nsr,tr->tns", want["evecs"], h) ** 2)
            np.testing.assert_allclose(bt, bj, rtol=1e-4,
                                       atol=1e-4 * np.abs(bj).max())
        v_l = -(-VOCAB // tp)
        assert res["stats"] == min(max(VOCAB - (r % tp) * v_l, 0), v_l)


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_full_beam_equals_sharded_and_dense_topk(runs, mesh):
    inp, _, _, ranks = runs
    dp, tp = mesh
    t_l = T // dp
    for r, res in enumerate(ranks[mesh]):
        rows = slice((r // tp) * t_l, (r // tp + 1) * t_l)
        want_ids, want_logits = _dense_topk(inp, rows)
        for tag in ("beam", "dense", "from_ref"):
            ids, logits = res[tag]
            np.testing.assert_array_equal(ids, want_ids, err_msg=tag)
            close(logits, want_logits, what=tag)
        ids, logits = res["narrow"]
        assert ids.shape == (t_l, K) and (ids < VOCAB).all()
        assert np.isfinite(logits).all()


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_engine_topk_on_the_mesh(runs, mesh):
    """youtube-dnn's engine paths, and llama3-8b's prefill / decode /
    top-k steps against the unsharded engine on the same weights."""
    inp, _, lm, ranks = runs
    dp, tp = mesh
    t_l, b_l = T // dp, (LM_BATCH * 2) // dp
    for r, res in enumerate(ranks[mesh]):
        i = r // tp
        want_ids, want_logits = _dense_topk(inp, slice(i * t_l,
                                                       (i + 1) * t_l))
        for tag, (ids, logits) in res["engine"].items():
            np.testing.assert_array_equal(ids, want_ids, err_msg=tag)
            close(logits, want_logits, what=tag)
        rows = slice(i * b_l, (i + 1) * b_l)
        got = res["lm"]
        np.testing.assert_array_equal(got["prefill"], lm["prefill"][rows])
        np.testing.assert_array_equal(got["decode"], lm["decode"][rows])
        for tag in ("dense", "index"):
            ids, logits = got[tag]
            np.testing.assert_array_equal(ids, lm["dense"][0][rows],
                                          err_msg=tag)
            close(logits, lm["dense"][1][rows], what=tag)


@pytest.mark.parametrize("tp", sorted({tp for _, tp in MESHES}))
def test_convert_sharded_index_both_ways(runs, tp):
    """The reference's concatenated per-shard builds cross onto each rank
    of a mesh as its own shard (decoded there: ``from_ref`` in the full
    beam test) and gather back field for field; the port's mesh build,
    each rank holding only its shard, gathers as the reference's fields,
    which construct the reference's index; off its mesh a sharded index
    is refused."""
    from repro.serve.retrieval import RetrievalIndex as JIndex
    from repro_torch import convert

    inp, _, _, ranks = runs
    fields = inp[f"ref_{tp}"]
    with pytest.raises(ValueError, match="mesh"):
        convert.index_from_jax(fields, device="cpu")
    v_l = -(-VOCAB // tp)
    for mesh in (m for m in MESHES if m[1] == tp):
        for r, res in enumerate(ranks[mesh]):
            back = res["ref_back"]
            assert (back["n"], back["tp"], back["v_shard"]) == (VOCAB, tp,
                                                                v_l)
            for k in FIELDS:
                np.testing.assert_array_equal(back[k], fields[k])
                assert res["held"][k] == np.split(fields[k], tp)[0].shape
            assert len(res["refused"]) == 2, res["refused"]
            port_fields = res["fields"]
            jidx = JIndex(**port_fields)
            assert (jidx.tp, jidx.v_shard) == (tp, v_l)
            for k in ("perm", "cnt", "wq"):
                np.testing.assert_array_equal(port_fields[k], fields[k])
