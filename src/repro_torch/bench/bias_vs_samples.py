"""Gradient bias of the eq. 5 estimator per sampler family x m — the port of
``benchmarks/bias_vs_samples.py::grad_bias`` (the paper's Fig. 2 question,
asked directly on a toy softmax model).

    from repro_torch.bench.bias_vs_samples import grad_bias
    rows = grad_bias(device="cpu")            # the card unless "cpu"

Same arguments and rows as the reference.  Two sections:

  * dense: negatives drawn from each family's EXACT all-class distribution
    over the NEGATIVE classes (the positive excluded and renormalized, the
    q of Theorem 2.1), the Monte-Carlo mean of the sampled gradient
    against the full-softmax gradient p - y;
  * real draws: ``block-quadratic-shared`` (blocks of 32) against tapas
    over it (a pool of ``two_stage_pool``), through the hit-masked eq. 5
    estimator, since real draws can collide with the label.

Each (query, m) draws its ``reps`` repetitions as one batch and accumulates
the mean by scatter-adds into (n,) sums, never as a (reps, n) table.  A
row's ``mc_se_linf`` is the Monte-Carlo standard error of that mean (the
largest over the classes, averaged over the queries): two runs of one
problem differ in ``bias_linf`` by a few of it at most.

The toy problem (w, the queries, their labels, rff's directions) comes
from a torch generator seeded with ``seed``, so its rows are not the
reference's draw of it; ``problem=`` takes given tensors instead.
"""
from __future__ import annotations

import json
import math

import torch

from repro_torch.core.samplers import (
    MIDXSampler,
    RFFSampler,
    SamplerState,
    TapasSampler,
    make_sampler,
)
from repro_torch.core.kernel_fns import rff_directions
from repro_torch.core.sampled_softmax import full_softmax_grad_wrt_logits
from repro_torch.utils.misc import resolve_device

Tensor = torch.Tensor

GRAD_BIAS_SAMPLERS = ["uniform", "quadratic-oracle", "midx", "rff",
                      "softmax"]
#: repetitions a batch of the real-draw section (the reference's chunk)
REAL_CHUNK = 250


def make_problem(n: int = 256, d: int = 12, n_queries: int = 4,
                 rff_dim: int = 512, seed: int = 0,
                 device: str | torch.device | None = None
                 ) -> dict[str, Tensor]:
    """The toy softmax model: w (n, d) ~ N(0, 0.25), queries (Q, d) ~
    N(0, 1.44), each query's label drawn from its softmax, and rff's
    directions omega (rff_dim, d)."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    w = torch.randn((n, d), generator=gen, device=dev) * 0.5
    hs = torch.randn((n_queries, d), generator=gen, device=dev) * 1.2
    labels = torch.multinomial(torch.softmax(hs @ w.T, dim=-1), 1,
                               generator=gen)[:, 0]
    omega = rff_directions(gen, rff_dim, d)
    return {"w": w, "hs": hs, "labels": labels, "omega": omega}


def family_logq(name: str, w: Tensor, h: Tensor, *, omega: Tensor,
                rff_dim: int = 512) -> Tensor:
    """A family's exact log q of every class for the query h: (n,).  rff
    (D = rff_dim, leaves of 16) uses the given directions ``omega``; midx
    takes 8 codewords and lists of 16, as the reference does."""
    n = w.shape[0]
    if name == "uniform":
        return torch.full((n,), -math.log(n), device=w.device)
    if name in ("rff", "midx"):
        sampler = (RFFSampler(dim=rff_dim, leaf_size=16) if name == "rff"
                   else MIDXSampler(codewords=8, list_size=16))
        const = {"omega": omega} if name == "rff" else {}
        state = SamplerState(stats=sampler.build_stats(w, n, const),
                             const=const)
        return sampler.all_class_logq(sampler.hydrate(state, n), h)[:n]
    sampler = make_sampler(name)
    return sampler.logq_all(sampler.island_state(w, n), h)


def mc_grad_sums(o: Tensor, label: Tensor, ids: Tensor, logq: Tensor, *,
                 mask_hits: bool) -> tuple[Tensor, Tensor]:
    """Sums over R repetitions of the eq. 5 gradient estimate
    (``sampled_softmax_grad_wrt_logits``) and of its square, per class.

    o: (n,) logits; label: 0-dim; ids / logq: (R, m) each repetition's
    negatives.  Returns (sum (n,), sum of squares (n,)) in fp64."""
    n = o.shape[0]
    r, m = ids.shape
    neg = o[ids] - (logq + math.log(m))
    if mask_hits:
        neg = torch.where(ids == label, -math.inf, neg)
    pos = o[label].expand(r, 1)
    p = torch.softmax(torch.cat([pos, neg], dim=1), dim=1).double()
    p[:, 0] -= 1.0  # the -y of (p' - y') at the label's slot
    slots = torch.cat([label.expand(r, 1), ids], dim=1)
    # one value per (repetition, class): slots of one class add up first
    keys = slots + n * torch.arange(r, device=o.device)[:, None]
    uniq, inv = torch.unique(keys.reshape(-1), return_inverse=True)
    per = torch.zeros(uniq.shape, dtype=torch.float64,
                      device=o.device).index_add_(0, inv, p.reshape(-1))
    cls = uniq % n
    zero = torch.zeros(n, dtype=torch.float64, device=o.device)
    return zero.index_add(0, cls, per), zero.index_add(0, cls, per * per)


def _row(name: str, m: int, diffs: list[Tensor], ses: list[Tensor]
         ) -> dict:
    return {"sampler": name, "m": int(m),
            "bias_linf": float(torch.stack([d.abs().max()
                                            for d in diffs]).mean()),
            "bias_l2": float(torch.stack([d.norm() for d in diffs]).mean()),
            "mc_se_linf": float(torch.stack([s.max() for s in ses]).mean())}


def _mean_se(total: Tensor, total_sq: Tensor, reps: int
             ) -> tuple[Tensor, Tensor]:
    mean = total / reps
    var = torch.clamp(total_sq / reps - mean * mean, min=0.0)
    return mean, torch.sqrt(var / reps)


def grad_bias(samplers=None, ms=(16, 64), n=256, d=12, n_queries=4,
              reps=8000, rff_dim=512, seed=0, quiet=False, out_json=None,
              two_stage_pool=128, *, device=None, problem=None) -> list[dict]:
    """Gradient bias of the eq. 5 estimator per sampler family x m: rows of
    {"sampler", "m", "bias_linf", "bias_l2", "mc_se_linf"} (means over the
    queries), the dense section's families first, then the real-draw
    section's ``block-quadratic-shared`` and ``tapas``.

    ``problem``: {"w", "hs", "labels", "omega"} in place of
    ``make_problem``'s draw (n, d and n_queries then follow its shapes)."""
    samplers = samplers or GRAD_BIAS_SAMPLERS
    dev = resolve_device(device)
    if problem is None:
        problem = make_problem(n, d, n_queries, rff_dim, seed, dev)
    w, hs = problem["w"].to(dev).float(), problem["hs"].to(dev).float()
    labels = problem["labels"].to(dev).long()
    omega = problem["omega"].to(dev).float()
    n = w.shape[0]
    gen = torch.Generator(dev).manual_seed(seed + 1)

    def query(t):
        o = w @ hs[t]
        full = full_softmax_grad_wrt_logits(o[None], labels[t][None])[0]
        return hs[t], o, labels[t], full.double()

    rows = []
    acc = {(name, m): ([], []) for name in samplers for m in ms}
    for t in range(hs.shape[0]):
        h, o, label, full = query(t)
        for name in samplers:
            logq = family_logq(name, w, h, omega=omega, rff_dim=rff_dim)
            # the theorem's q excludes the positive
            logq = torch.where(torch.arange(n, device=dev) == label,
                               -math.inf, logq)
            logq = logq - torch.logsumexp(logq, dim=0)
            for m in ms:
                ids = torch.multinomial(logq.exp(), reps * m,
                                        replacement=True,
                                        generator=gen).reshape(reps, m)
                mean, se = _mean_se(*mc_grad_sums(o, label, ids, logq[ids],
                                                  mask_hits=False), reps)
                acc[(name, m)][0].append(mean - full)
                acc[(name, m)][1].append(se)
    for name in samplers:
        for m in ms:
            rows.append(_row(name, m, *acc[(name, m)]))
            _log(quiet, name, rows[-1])

    # real-draw two-stage section: tapas vs its pass-1 base, hit-masked
    base = make_sampler("block-quadratic-shared", block_size=32)
    tap = TapasSampler(base=base, pool=two_stage_pool)
    state = base.init_state(gen, w)
    runtimes = {"block-quadratic-shared": base.hydrate(state, n),
                "tapas": tap.island_runtime(state, w, n)}
    for name in ("block-quadratic-shared", "tapas"):
        rt = runtimes[name]
        acc2 = {m: ([], []) for m in ms}
        for t in range(hs.shape[0]):
            h, o, label, full = query(t)
            for m in ms:
                total = torch.zeros(n, dtype=torch.float64, device=dev)
                total_sq = torch.zeros_like(total)
                for lo in range(0, reps, REAL_CHUNK):
                    c = min(REAL_CHUNK, reps - lo)
                    ids, logq = _real_draws(name, base, tap, rt, h, m, c,
                                            gen)
                    s1, s2 = mc_grad_sums(o, label, ids, logq,
                                          mask_hits=True)
                    total += s1
                    total_sq += s2
                mean, se = _mean_se(total, total_sq, reps)
                acc2[m][0].append(mean - full)
                acc2[m][1].append(se)
        for m in ms:
            rows.append(_row(name, m, *acc2[m]))
            _log(quiet, name + "[real]", rows[-1])
    if out_json:
        with open(out_json, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


def _real_draws(name, base, tap, rt, h, m, c, gen):
    """c independent repetitions of the sampler's own draws for the 1-row
    batch h: (ids (c, m), logq (c, m)).  A shared draw set for a fixed
    batch is i.i.d. per draw, so c sets of m are one call of c*m; tapas
    draws c independent pools the same way and resamples each against h."""
    if name == "tapas":
        pools, logq1 = base.sample_batch(rt["base"], h[None], c * tap.pool,
                                         gen)
        return tap.resample_from_pool(
            rt, pools.reshape(c, tap.pool), logq1.reshape(c, tap.pool),
            h.expand(c, -1), m, gen)
    ids, logq = base.sample_batch(rt, h[None], c * m, gen)
    return ids.reshape(c, m), logq.reshape(c, m)


def _log(quiet: bool, name: str, row: dict) -> None:
    if not quiet:
        print(f"  grad-bias {name:18s} m={row['m']:4d} "
              f"linf={row['bias_linf']:.4f} l2={row['bias_l2']:.4f} "
              f"(mc se {row['mc_se_linf']:.4f})", flush=True)
