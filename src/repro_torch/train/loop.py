"""The training loop (``repro.train.loop::fit``).

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

Checkpoint/restart (``checkpoint_dir``): the loop begins by probing the
directory and restoring the latest step with the data iterator's state
(``restored_from``), saves every ``checkpoint_every`` steps in the
background and makes a blocking final save.  Resuming is exact: the
iterator and the steps' generators are pure functions of (seed, step).

``refresh_mode="overlap"``: a ``RefreshIsland`` rebuilds the sampler's
statistics from snapshots on a side CUDA stream and swaps them in a fixed
``refresh_stale_steps`` later.

On a ``(data, model)`` mesh ``fit`` runs on every rank with the same
arguments and ``data`` built with the same ctx: the losses alike on every
rank, either refresh mode.  Checkpoints on a mesh raise (ROADMAP.md A17).
"""
from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Any, Callable

import torch

from repro_torch import kernels
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core.samplers import SamplerState
from repro_torch.data.pipeline import ShardedBatchIterator
from repro_torch.models import api
from repro_torch.optim.transform import GradientTransform
from repro_torch.sharding import rules
from repro_torch.train.step import (
    TrainState,
    init_train_state,
    make_refresh_fn,
    make_train_step,
)
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
    # kernel launches of the island's rebuilds, by kernel (overlap only)
    refresh_launches: dict[str, int] = dataclasses.field(default_factory=dict)


class RefreshIsland:
    """Double-buffered sampler-stat refresh off the step
    (``refresh_mode="overlap"``, the reference's ``RefreshIsland``).

    On a cadence step the island SNAPSHOTS both rebuild inputs on the main
    stream — a clone of the head table and of the carried sampler state
    (the optimizer updates the parameters in place) — and runs
    ``make_refresh_fn`` on them on a side CUDA stream that first waits for
    the main stream.  Exactly ``cfg.refresh_stale_steps`` steps after
    dispatch the result is swapped into ``TrainState.sampler_state``, and
    the main stream waits on an event recorded after the rebuild (the host
    never blocks).  A fixed-k swap keeps the q sequence deterministic run
    to run.  The correction always uses the statistics actually sampled
    from, so staleness costs bias-of-q only.

    The stream hides the rebuild's device time, not its host time: the
    kernels are launched from this thread, inside the dispatching step (a
    worker thread contends with the step for the GIL: on an H100 one midx
    rebuild added more to a step from a worker thread than from the
    step's own, ``chip_smoke.py``'s ``thread_probe``).
    Blocks the side stream allocates and the main stream reads are
    ``record_stream``-ed to the main stream, and the snapshots to the side
    stream, so the caching allocator never hands them out while the other
    stream may still use them.  On the CPU the rebuild runs inline.

    On a mesh (``ctx`` the train ctx) each rank rebuilds its own shard:
    the snapshot is its head shard with the feature dim all-gathered over
    ``data`` (``api.head_table(..., ctx)``), issued on the main stream at
    snapshot time, at the same step on every rank; the side stream then
    runs only the rank-local build, with no collective.  Every rank
    dispatches and swaps at the same steps, so the q sequence stays alike
    across ranks.

    ``launches`` counts the kernel launches of the island's rebuilds (the
    step's are the global counters less these)."""

    def __init__(self, cfg: ArchConfig, ctx,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.ctx = ctx if rules.on_mesh(ctx) else None
        self.cadence = max(cfg.sampler_refresh_every, 1)
        self.k = max(cfg.refresh_stale_steps, 1)
        self._refresh = make_refresh_fn(cfg, ctx)
        self.enabled = self._refresh.carries_stats
        dev = resolve_device(device)
        self._side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        # (dispatch step, head snapshot, state snapshot, result, done event)
        self._inflight: tuple | None = None
        self._active_from = 0  # step whose head built the active stats
        self.swaps = 0
        self.launches = dict.fromkeys(kernels.launch_counts(), 0)

    def _snapshot(self, params) -> torch.Tensor:
        """The head as the rebuild reads it, copied (the optimizer updates
        the parameters in place); on a mesh gathered over ``data`` here,
        on the main stream."""
        with torch.no_grad():
            return api.head_table(params, self.cfg,
                                  self.ctx).detach().clone()

    @staticmethod
    def _snap_state(sstate: SamplerState) -> SamplerState:
        return SamplerState(
            stats={k: v.clone() for k, v in sstate.stats.items()},
            const={k: v.clone() for k, v in sstate.const.items()})

    def _rebuild(self, head: torch.Tensor, sstate: SamplerState
                 ) -> tuple[SamplerState, Any]:
        """The rebuild of the snapshots (side stream on the card), its
        launches counted apart; returns (result, its done event)."""
        before = kernels.launch_counts()
        if self._side is None:
            new, done = self._refresh(head, sstate), None
        else:
            main = torch.cuda.current_stream(head.device)
            self._side.wait_stream(main)
            for t in (head, *sstate.stats.values(), *sstate.const.values()):
                t.record_stream(self._side)
            with torch.cuda.stream(self._side):
                new = self._refresh(head, sstate)
                done = torch.cuda.Event()
                done.record(self._side)
            for t in (*new.stats.values(), *new.const.values()):
                t.record_stream(main)
        for name, n in kernels.launch_counts().items():
            self.launches[name] += n - before[name]
        return new, done

    def prime(self, state: TrainState) -> TrainState:
        """Blocking first rebuild, so the first window starts from
        statistics of the current head."""
        if not self.enabled:
            return state
        sstate, done = self._rebuild(self._snapshot(state.params),
                                     self._snap_state(state.sampler_state))
        if done is not None:
            done.synchronize()
        self._active_from = state.step
        return dataclasses.replace(state, sampler_state=sstate)

    def before_step(self, i: int, state: TrainState
                    ) -> tuple[TrainState, dict[str, float]]:
        """Swap a due rebuild in, then dispatch the next one on the
        cadence.  Returns the state and the telemetry ``fit`` reads (also
        when the island is disabled: a stateless sampler or a dense
        estimator)."""
        if not self.enabled:
            return state, {"refresh_staleness_steps": 0.0,
                           "refresh_block_ms": 0.0}
        block_ms = 0.0
        if self._inflight is not None and i - self._inflight[0] >= self.k:
            t0 = time.perf_counter()
            sent, _, _, sstate, done = self._inflight
            if done is not None:
                torch.cuda.current_stream(done.device).wait_event(done)
            block_ms = (time.perf_counter() - t0) * 1e3
            state = dataclasses.replace(state, sampler_state=sstate)
            self._active_from = sent
            self._inflight = None
            self.swaps += 1
        if i % self.cadence == 0 and self._inflight is None:
            head = self._snapshot(state.params)
            snap = self._snap_state(state.sampler_state)
            self._inflight = (i, head, snap, *self._rebuild(head, snap))
        return state, {"refresh_staleness_steps": float(i - self._active_from),
                       "refresh_block_ms": block_ms}


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
        max_len: int = 4096,
        device: str | torch.device | None = None) -> LoopResult:
    """Train up to step ``steps`` on ``device`` (the card unless
    ``device="cpu"``): from the latest checkpoint in ``checkpoint_dir`` if
    there is one, else from a fresh state drawn from ``seed``.
    ``max_len`` sizes an encoder-decoder's learned position tables, as in
    the reference (the other families have none).  On a mesh the mode is
    ``cfg``'s (``rules.ctx_for_train``), whatever ``ctx``'s, as ``data``
    (``batch_iterator_for``) takes it."""
    if checkpoint_dir and rules.on_mesh(ctx):
        raise NotImplementedError(
            "checkpoints on a mesh (per-process shards) are not ported "
            "(ROADMAP.md A17)")
    if rules.on_mesh(ctx):
        ctx = rules.ctx_for_train(ctx.mesh, cfg)
    dev = resolve_device(device)
    step_fn = make_train_step(cfg, ctx, opt)
    island = RefreshIsland(cfg, ctx, dev) \
        if cfg.refresh_mode == "overlap" else None
    mgr = CheckpointManager(checkpoint_dir, keep=keep) \
        if checkpoint_dir else None
    state = init_train_state(torch.Generator(dev).manual_seed(seed), cfg,
                             ctx, opt, max_len, device=dev)
    restored_from = None
    if mgr is not None and mgr.latest_step() is not None:
        state, extra = mgr.restore(like=state, device=dev)
        restored_from = int(extra.get("step", mgr.latest_step()))
        if "data_state" in extra:
            data.load_state(extra["data_state"])
    if island is not None:
        state = island.prime(state)

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
    try:
        for i in range(state.step, steps):
            if fail_at_step is not None and i == fail_at_step:
                raise RuntimeError(f"injected failure at step {i}")
            batch = next(data)
            if pending is not None:
                flush(pending)
                pending = None
            t0 = time.perf_counter()
            if slow_step_injection and i in slow_step_injection:
                time.sleep(slow_step_injection[i])  # test hook: straggler
            if island is not None:
                state, rmetrics = island.before_step(i, state)
            else:
                rmetrics = {"refresh_staleness_steps": float(i % cadence),
                            "refresh_block_ms": 0.0}
            refresh_staleness.append(
                int(rmetrics["refresh_staleness_steps"]))
            state, metrics = step_fn(state, batch,
                                     step_generator(seed, i, dev))
            metrics = {**metrics, **rmetrics}
            pending = (i, metrics, t0, state)
            # the last step's state is the final save's, below
            if mgr is not None and (i + 1) % checkpoint_every == 0 \
                    and i + 1 < steps:
                mgr.save(i + 1, state, extra={
                    "step": i + 1, "data_state": data.state_dict()})
    except BaseException:
        # A step that raises leaves the process: let the checkpoint
        # already copied to the host land first (the loop's own error is
        # the one reported), or the relaunch resumes from the one before.
        if mgr is not None:
            with contextlib.suppress(RuntimeError):
                mgr.wait()
        raise
    if pending is not None:
        flush(pending)
    if mgr is not None:
        mgr.save(steps, state,
                 extra={"step": steps, "data_state": data.state_dict()},
                 blocking=True)
    return LoopResult(state=state, losses=losses, straggler_steps=stragglers,
                      restored_from=restored_from,
                      refresh_swaps=island.swaps if island else 0,
                      refresh_staleness=refresh_staleness,
                      refresh_launches=dict(island.launches) if island
                      else {})
