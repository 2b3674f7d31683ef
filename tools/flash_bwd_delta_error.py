#!/usr/bin/env python3
"""Measure how the attention backward's D = rowsum(dO o O) depends on the
precision of O, as keys gain a common mean.

The backward forms dS = P o (dP - D) with one D per query row.  A D taken
from the forward's output rounded to bf16 is off by a per-row amount, and
dQ = scale * dS K then carries that amount along the attention-weighted
mean key: the larger the keys' shared mean (a key bias, a trained model's
keys), the larger dQ's error against the exact chain rule.  D summed as
rowsum(P o dP) from the fp32 P and dP (what ``flash_attention_bwd`` does)
has no such term.

This script computes, in fp64 on one causal head of 256 queries and 64
dims with bf16-representable inputs, max |dQ(D) - dQ(exact)| / max
|dQ(exact)| for key means 0, 1, 3 and 10, with D from:

* the bf16 O;
* the bf16 O plus its bf16 remainder O_lo = bf16(O_fp32 - bf16(O_fp32)),
  O_fp32 formed as the forward kernel forms it (the unnormalised P as bf16
  hi + lo in P V, fp32 sums): the route that would let the backward skip
  its D sweep;
* the same O_fp32 unrounded (an fp32 remainder);
* rowsum(P o dP) in fp32.

CPU only; a second.

Run from the repo root:  PYTHONPATH=src python3 tools/flash_bwd_delta_error.py
"""
import math

import torch

B, H, S, HD = 1, 4, 256, 64
ROUTES = ("bf16 O", "bf16 O + O_lo", "fp32 O", "rowsum(P dP) fp32")


def dq_errors(key_mean: float, seed: int = 0) -> dict[str, float]:
    gen = torch.Generator().manual_seed(seed)

    def draw(shift=0.0):
        x = torch.randn((B, H, S, HD), generator=gen) + shift
        return x.bfloat16().double()

    q, k, v, do = draw(), draw(key_mean), draw(), draw()
    scale = 1.0 / math.sqrt(HD)
    s = (q @ k.transpose(-1, -2)) * scale
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -math.inf)
    p = torch.softmax(s, dim=-1)
    o = p @ v
    dp = do @ v.transpose(-1, -2)

    def dq_with(d):
        return (p * (dp - d[..., None])) @ k * scale

    # O_fp32 as the forward kernel forms it: exp(s - max) as bf16 hi + lo
    pu = torch.exp(s - s.amax(-1, keepdim=True)).float()
    hi = pu.bfloat16().float()
    lo = (pu - hi).bfloat16().float()
    o32 = ((hi.double() + lo.double()) @ v / pu.sum(-1, keepdim=True).double()
           ).float()
    o_hi = o32.bfloat16().float()
    o_lo = (o32 - o_hi).bfloat16().float()
    d32 = do.float()
    ds = {"bf16 O": (do * o.bfloat16().double()).sum(-1),
          "bf16 O + O_lo": (d32 * (o_hi + o_lo)).sum(-1).double(),
          "fp32 O": (d32 * o32).sum(-1).double(),
          "rowsum(P dP) fp32": (p.float() * dp.float()).sum(-1).double()}
    exact = dq_with((do * o).sum(-1))
    top = float(exact.abs().max())
    return {name: float((dq_with(d) - exact).abs().max()) / top
            for name, d in ds.items()}


def main() -> None:
    print("max|dq err| / max|dq| with D from: " + "; ".join(ROUTES))
    for mean in (0.0, 1.0, 3.0, 10.0):
        errs = dq_errors(mean)
        print(f"key mean {mean:4.1f}: " + "  ".join(
            f"{errs[name]:.2e}" for name in ROUTES))


if __name__ == "__main__":
    main()
