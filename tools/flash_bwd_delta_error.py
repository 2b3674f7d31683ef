#!/usr/bin/env python3
"""Measure how the attention backward's D = rowsum(dO o O) depends on the
precision of O, as keys gain a common mean.

The backward forms dS = P o (dP - D) with one D per query row.  A D taken
from the forward's output rounded to bf16 is off by a per-row amount, and
dQ = scale * dS K then carries that amount along the attention-weighted
mean key: the larger the keys' shared mean (a key bias, a trained model's
keys), the larger dQ's error against the exact chain rule.  D summed as
rowsum(P o dP) from the fp32 P and dP (what ``flash_attention_bwd`` does)
has no such term.  This script computes, in fp64 on one causal head of
256 queries and 64 dims with bf16-representable inputs, max |dQ(D from
bf16 O) - dQ(exact)| / max |dQ(exact)| for key means 0, 1, 3 and 10,
beside the same with D = rowsum(P o dP) in fp32.  CPU only; a second.

Run from the repo root:  PYTHONPATH=src python3 tools/flash_bwd_delta_error.py
"""
import math

import torch

B, H, S, HD = 1, 4, 256, 64


def dq_errors(key_mean: float, seed: int = 0) -> tuple[float, float]:
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

    exact = dq_with((do * o).sum(-1))
    from_bf16_o = dq_with((do * o.bfloat16().double()).sum(-1))
    p32, dp32 = p.float(), dp.float()
    from_p_dp = dq_with((p32 * dp32).sum(-1).double())
    top = float(exact.abs().max())
    return (float((from_bf16_o - exact).abs().max()) / top,
            float((from_p_dp - exact).abs().max()) / top)


def main() -> None:
    for mean in (0.0, 1.0, 3.0, 10.0):
        bf16_o, p_dp = dq_errors(mean)
        print(f"key mean {mean:4.1f}: max|dq err| / max|dq| with D from "
              f"bf16 O {bf16_o:.2e}, with D = rowsum(P dP) in fp32 "
              f"{p_dp:.2e}")


if __name__ == "__main__":
    main()
