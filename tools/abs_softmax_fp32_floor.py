#!/usr/bin/env python3
"""Measure the fp32 floor of ptb-lstm's full-softmax gradients, with and
without the abs mode of its config (``abs_softmax``: the logits' absolute
values), on one card.

The abs mode's |x| has a kink at 0: a logit within a few ulps of 0 takes
the sign of its last bits, so a last-bit change of the hidden states (two
GEMM shapes, fp32 against float64) flips that logit's gradient, a jump of
2 p h.  This script takes one fp32 step's loss and gradients of ptb-lstm
at full width (vocab 10,000, 2 layers of 200, batch 20 x 35, seeded
weights and tokens) with the whole batch, and with its two halves of 10
rows summed (the data split of a (2, 2) mesh), each against the float64
step, in both modes, and prints each gradient's max error over its
float64 max.  The parity gate of ``chip_smoke.py``'s phase 25 holds 1e-5
of each tensor's max, so its ptb-lstm parity step takes the plain mode.

Run on the card from the repo root:  python3 tools/abs_softmax_fp32_floor.py
(about 15 s on one H100).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import estimators  # noqa: E402
from repro_torch.data.pipeline import batch_iterator_for  # noqa: E402
from repro_torch.models import lstm_lm  # noqa: E402

SEED = 25
BATCH, SEQ = 20, 35


def step_grads(cfg, batch, base, dtype, split, abs_mode):
    """(loss, {name: float64 gradient}) of one full-softmax step of the
    model ``base`` cast to ``dtype``, over ``split``'s row blocks summed."""
    dev = next(base.parameters()).device
    model = lstm_lm.LSTMLM(cfg, dev)
    with torch.no_grad():
        for p, q in zip(model.parameters(), base.parameters()):
            p.data = q.detach().to(dtype)
    est = estimators.make_estimator("full")
    total = 0.0
    for rows in split:
        h, _ = lstm_lm.hidden_states(model, batch["tokens"][rows], cfg)
        loss = estimators.loss_from_embeddings(
            est, model.head_w, h.reshape(-1, h.shape[-1]),
            batch["labels"][rows].reshape(-1), None, None,
            abs_mode=abs_mode).sum() / (BATCH * SEQ)
        loss.backward()
        total += float(loss.detach())
    return total, {k: p.grad.double() for k, p in model.named_parameters()}


def rel(a: dict, b: dict) -> dict:
    return {k: float((a[k] - b[k]).abs().max() / b[k].abs().max())
            for k in b}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = get_config("ptb-lstm")
    batch = next(batch_iterator_for(cfg, None, BATCH, SEQ, seed=SEED,
                                    device=dev))
    base = lstm_lm.init_lstm_lm(torch.Generator(dev).manual_seed(SEED), cfg,
                                dev)
    print(torch.cuda.get_device_name(0))
    whole, halves = [slice(0, BATCH)], [slice(0, BATCH // 2),
                                        slice(BATCH // 2, BATCH)]
    for abs_mode in (True, False):
        _, g64 = step_grads(cfg, batch, base, torch.float64, whole, abs_mode)
        got = {tag: step_grads(cfg, batch, base, torch.float32, split,
                               abs_mode)[1]
               for tag, split in (("whole", whole), ("halves", halves))}
        for tag, g in got.items():
            print(f"abs_softmax={abs_mode} fp32 {tag} batch against float64:"
                  f" {rel(g, g64)}")
        print(f"abs_softmax={abs_mode} fp32 whole against halves: "
              f"{rel(got['halves'], got['whole'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
