"""The training loop, sync refresh (``repro.train.loop::fit``).

Per step: fetch the batch, run the train step with a generator seeded from
(seed + 1, step) — the reference's ``fold_in(PRNGKey(seed + 1), i)`` — and
record the loss.  Metric reads are pipelined one step deep, as in the
reference: step i's loss is read on the host (which waits for the device)
after step i+1's batch is fetched and before its timed region opens, so a
stall at step i+1 is never charged to step i.

Stragglers: per-step wall time against the running median of post-warmup
steps (the first ``straggler_warmup`` steps, with their one-time kernel
builds and allocations, never enter the window); ``fail_at_step`` and
``slow_step_injection`` are test hooks.

Checkpointing (``checkpoint_dir``) arrives with ROADMAP.md A10 and the
overlapped refresh island with A9; both raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import ShardedBatchIterator
from repro_torch.optim.transform import GradientTransform
from repro_torch.train.step import TrainState, init_train_state, \
    make_train_step
from repro_torch.utils.misc import fold_in, resolve_device


@dataclasses.dataclass
class LoopResult:
    state: TrainState
    losses: list[float]
    straggler_steps: list[int]
    restored_from: int | None
    # refresh-island telemetry (overlap mode; zeros under "sync")
    refresh_swaps: int = 0
    refresh_staleness: list[int] = dataclasses.field(default_factory=list)


def step_generator(seed: int, i: int, device: torch.device
                   ) -> torch.Generator:
    """The generator of step ``i``'s negatives."""
    return torch.Generator(device).manual_seed(fold_in(seed + 1, i))


def fit(cfg: ArchConfig, ctx, opt: GradientTransform,
        data: ShardedBatchIterator, steps: int, *,
        checkpoint_dir: str | None = None, checkpoint_every: int = 50,
        keep: int = 3, seed: int = 0, straggler_factor: float = 3.0,
        straggler_warmup: int = 1, straggler_min_window: int = 3,
        fail_at_step: int | None = None,
        slow_step_injection: dict[int, float] | None = None,
        log_every: int = 10,
        eval_fn: Callable[[TrainState], float] | None = None,
        device: str | torch.device | None = None) -> LoopResult:
    """Train ``steps`` steps from a fresh state drawn from ``seed`` on
    ``device`` (the card unless ``device="cpu"``)."""
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpoints are not ported yet (ROADMAP.md A10)")
    dev = resolve_device(device)
    step_fn = make_train_step(cfg, ctx, opt)
    state = init_train_state(torch.Generator(dev).manual_seed(seed), cfg,
                             ctx, opt, device=dev)

    losses: list[float] = []
    stragglers: list[int] = []
    durations: list[float] = []
    measured = 0
    pending: tuple[int, Any, float, TrainState] | None = None

    def flush(p: tuple[int, Any, float, TrainState]) -> None:
        nonlocal measured
        i_p, metrics_p, t0_p, state_p = p
        loss = float(metrics_p["loss"])  # waits for the step on the device
        dt = time.perf_counter() - t0_p
        losses.append(loss)
        if measured >= straggler_warmup:
            if len(durations) >= straggler_min_window:
                med = statistics.median(durations[-50:])
                if dt > straggler_factor * med:
                    stragglers.append(i_p)
            durations.append(dt)
        measured += 1
        if log_every and i_p % log_every == 0:
            extra_s = ""
            if eval_fn is not None:
                extra_s = f" eval={eval_fn(state_p):.4f}"
            print(f"step {i_p:5d} loss {loss:.4f} "
                  f"({dt*1e3:.0f} ms){extra_s}", flush=True)

    cadence = max(cfg.sampler_refresh_every, 1)
    refresh_staleness: list[int] = []
    for i in range(state.step, steps):
        if fail_at_step is not None and i == fail_at_step:
            raise RuntimeError(f"injected failure at step {i}")
        batch = next(data)
        if pending is not None:
            flush(pending)
            pending = None
        t0 = time.perf_counter()
        if slow_step_injection and i in slow_step_injection:
            time.sleep(slow_step_injection[i])  # test hook: fake straggler
        refresh_staleness.append(i % cadence)
        state, metrics = step_fn(state, batch, step_generator(seed, i, dev))
        pending = (i, metrics, t0, state)
    if pending is not None:
        flush(pending)
    return LoopResult(state=state, losses=losses, straggler_steps=stragglers,
                      restored_from=None,
                      refresh_staleness=refresh_staleness)
