"""Checkpointing, single process (``repro.checkpoint.manager``): atomic,
keep-K, async.

Layout per step, the reference's:  <dir>/step_00000123/
    manifest.json   — ``step``, ``extra`` (e.g. the data iterator's state)
                      and ``keys``, the sorted array names
    arrays.npz      — one entry per leaf, named by its path

Keys follow the reference's path rules, so either package restores the
other's checkpoints: a dataclass field is ``.name``, a dict key its name,
a tuple or list entry its index, joined by ``/``.  A port ``TrainState``
is flattened in the reference's tree (``convert.reference_tree``: params
nested by name, ``.step`` a 0-d int32 array), e.g.
``.params/head/w``, ``.opt_state/1/m/head/w``, ``.sampler_state/.stats/z``;
a ``StackedLM``'s layers stacked per segment as the reference holds them
(``.params/segments/0/attn/wq``), on the host only.  bf16 arrays are
stored as numpy stores the reference's: 2-byte voids holding their bits.

Contracts:

  * atomicity — write to ``step_XXXXXXXX.tmp``, fsync both files and the
    tmp directory, ``os.replace`` it to its final name, then fsync the
    parent: a crash leaves either no step or a complete one, and only
    complete (renamed, manifest-bearing) steps list.  A re-save onto an
    existing final directory replaces it;
  * async — ``save`` copies every tensor to the host before it returns
    (the next step updates the parameters in place), and the disk write
    runs on a background thread.  ``save`` joins the previous writer
    first, so two writes never overlap (the newer one's keep-K GC could
    delete the older one's step), and a background failure re-raises from
    the next ``wait()``;
  * keep-K GC — only the newest ``keep`` steps stay.

Per-process shard files (the reference's multi-process format) arrive
with the multi-device slice (ROADMAP.md A17).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import convert
from repro_torch.train.step import TrainState
from repro_torch.utils.misc import resolve_device


def _reference_form(tree: Any) -> Any:
    """The tree whose paths name the arrays: a ``TrainState`` in the
    reference's layout, anything else as it is."""
    return convert.reference_tree(tree) if isinstance(tree, TrainState) \
        else tree


def _map_leaves(fn, tree: Any, prefix: str = "") -> Any:
    """``tree`` with each leaf replaced by ``fn(key, leaf)``, keyed by the
    reference's path rules (a dataclass field ``.name``, a dict key, a
    sequence index, joined by ``/``).  ``None`` is no leaf."""
    def key(k) -> str:
        return f"{prefix}/{k}" if prefix else str(k)

    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_leaves(fn, getattr(tree, f.name), key(f".{f.name}"))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, key(k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v, key(i))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(prefix, tree)


def _leaves(tree: Any) -> list[tuple[str, Any]]:
    """(key, leaf) of every leaf of ``tree``."""
    out: list[tuple[str, Any]] = []
    _map_leaves(lambda k, v: out.append((k, v)), tree)
    return out


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    """Host copies of every leaf, by key (logical tensors)."""
    return {k: convert.host_copy(v)
            for k, v in _leaves(_reference_form(tree))}


def _fsync_dir(path: str) -> None:
    """Flush a DIRECTORY's entry list: file fsyncs make the bytes durable,
    but the files' existence (and a rename into the directory) is durable
    only once the directory itself is synced."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._launch_lock = threading.Lock()

    # -- write ---------------------------------------------------------------
    def save(self, step: int, state: Any, extra: dict | None = None,
             blocking: bool = False) -> None:
        # The previous write lands first, so one state's host copies are
        # held at a time (a 3B-parameter model's train state is 32 GB).
        self.wait()
        arrays = _flatten(state)  # host copies now: a consistent snapshot
        manifest = {"step": int(step), "extra": extra or {},
                    "keys": sorted(arrays)}

        def write():
            final = os.path.join(self.directory, f"step_{step:08d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)  # a previous crash's debris
            os.makedirs(tmp)
            # Durability order: payload bytes -> the tmp directory's
            # entries -> rename -> the rename's directory entry.  Skipping
            # one lets a crash leave a step that lists as complete but
            # reads back truncated.
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            try:
                os.replace(tmp, final)
            except OSError:
                # A non-empty final directory: a crashed run relaunched at
                # the same cadence wrote this step before.  The re-save
                # wins.
                shutil.rmtree(final, ignore_errors=True)
                os.replace(tmp, final)
            _fsync_dir(self.directory)
            self._gc()

        if blocking:
            self.wait()
            write()
            return
        with self._launch_lock:
            self.wait()  # never two write() bodies at once
            self._thread = threading.Thread(target=self._run_write(write),
                                            daemon=True)
            self._thread.start()

    def _run_write(self, write):
        def runner():
            try:
                write()
            except BaseException as e:  # noqa: BLE001
                self._error = e  # re-raised by the next wait()/save()

        return runner

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint write failed") from err

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: int | None = None,
                device: str | torch.device | None = None
                ) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` (values ignored; ``meta``
        tensors are fine) on ``device`` (the card unless ``device="cpu"``):
        each leaf a tensor of the like leaf's dtype.  Returns (state,
        the manifest's ``extra``)."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        base = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)
        tree = _reference_form(like)
        new = {}
        with np.load(os.path.join(base, "arrays.npz")) as data:
            for key, leaf in _leaves(tree):
                if key not in data:
                    raise KeyError(
                        f"checkpoint step {step} has no array '{key}': the "
                        "stored state layout does not match `like` (e.g. a "
                        "different sampler family's SamplerState, or a "
                        "checkpoint from before a state-layout change).  "
                        f"Stored keys: {manifest['keys']}")
                arr = convert.from_numpy(data[key])
                dtype = leaf.dtype if isinstance(
                    leaf, (torch.Tensor, convert.Stacked)) else arr.dtype
                new[key] = arr.to(device=dev, dtype=dtype)
        out = _map_leaves(lambda k, _: new[k], tree)
        if isinstance(like, TrainState):
            out = convert.from_reference_tree(out, like)
        return out, manifest["extra"]
