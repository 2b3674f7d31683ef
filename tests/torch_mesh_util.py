"""Helpers of the port's mesh tests (``test_torch_distributed.py``,
``test_torch_mesh_train.py``, ``test_torch_mesh_serving.py``).

``start_meshes`` runs a function on every rank of each ``(dp, tp)``
mesh: one spawned process a rank, one thread each, a gloo world started
through a ``FileStore`` in the test's own directory (so xdist workers
never clash on a port).  ``Reference`` runs a script of the JAX package's
side in a subprocess that forces several host devices before it imports
jax, as ``tests/dist_scripts/`` do, and hands back its npz.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

REPO = Path(__file__).resolve().parents[1]
MESHES = ((1, 2), (2, 2), (1, 4))
RANK_TIMEOUT_S = 240


def mesh_id(mesh) -> str:
    return f"{mesh[0]}x{mesh[1]}"


def _entry(rank: int, world: int, dp: int, tp: int, out: str, fn):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.sharding import rules

    try:
        launch_mesh.init_distributed("gloo", init_method=f"file://{out}/store",
                                     rank=rank, world_size=world)
        ctx = rules.mesh_ctx(launch_mesh.make_debug_mesh(dp, tp,
                                                         device_type="cpu"))
        with open(f"{out}/args.pkl", "rb") as f:
            args = pickle.load(f)
        torch.save(fn(ctx, *args), f"{out}/rank{rank}.pt")
    except BaseException:
        Path(f"{out}/rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """The spawned ranks of one mesh; ``result()`` waits for them."""

    def __init__(self, fn, mesh, out_dir: Path, *args):
        dp, tp = mesh
        self.mesh, self.world = mesh, dp * tp
        self.out = Path(out_dir) / f"{fn.__name__}_{mesh_id(mesh)}"
        self.out.mkdir(parents=True)
        # through a file, not the start pipe: a start() whose pickle fills
        # the pipe waits for the child's imports, one child after another
        with open(self.out / "args.pkl", "wb") as f:
            pickle.dump(args, f)
        spawn = mp.get_context("spawn")
        self.procs = [spawn.Process(target=_entry,
                                    args=(r, self.world, dp, tp,
                                          str(self.out), fn))
                      for r in range(self.world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + RANK_TIMEOUT_S

    def result(self) -> list:
        """The ranks' results in rank order (rank = data position * tp +
        model position).  A rank that raises or outlives RANK_TIMEOUT_S
        fails the call, the others are killed."""
        procs = self.procs
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > self.deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        errs = [e.read_text() for e in sorted(self.out.glob("rank*.err"))]
        codes = [p.exitcode for p in procs]
        assert not errs and codes == [0] * self.world, (
            f"ranks of the {mesh_id(self.mesh)} mesh failed (exit codes "
            f"{codes}):\n" + "\n".join(errs))
        return [torch.load(self.out / f"rank{r}.pt", weights_only=False)
                for r in range(self.world)]


def start_meshes(fn, out_dir: Path, *args, meshes=MESHES) -> dict:
    """``fn(ctx, *args)`` on every rank of each mesh, all meshes at once:
    {mesh: Ranks}."""
    return {mesh: Ranks(fn, mesh, out_dir, *args) for mesh in meshes}


class Reference:
    """A running reference subprocess; ``result()`` waits for its npz."""

    def __init__(self, script: str, inputs: dict, out_dir: Path,
                 devices: int = 8, timeout: int = 600):
        out_dir = Path(out_dir)
        self._in, self._out = out_dir / "ref_in.npz", out_dir / "ref_out.npz"
        np.savez(self._in, **inputs)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count="
                             f"{devices}",
                   PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO / 'tests'}")
        self._timeout = timeout
        self._proc = subprocess.Popen(
            [sys.executable, "-c", script, str(self._in), str(self._out)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def result(self) -> dict:
        try:
            _, err = self._proc.communicate(timeout=self._timeout)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            raise
        assert self._proc.returncode == 0, err[-4000:]
        with np.load(self._out) as f:
            return dict(f)


def close(got, want, rtol: float = 1e-5, what: str = "") -> None:
    """fp32 agreement: each element within rtol of itself or rtol of the
    largest magnitude (gradients hold many near-zero entries)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)
