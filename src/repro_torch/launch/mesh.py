"""The 2-D ``(data, model)`` process mesh (``repro.launch.mesh``).

Kept as FUNCTIONS, never module-level state: importing this module starts
no process group and touches no device.

A mesh is PyTorch's ``DeviceMesh`` over the world of ranks, ``dp`` rows
by ``tp`` columns, dims ``("data", "model")``: rank ``i * tp + j`` sits at
data position ``i`` and model position ``j``.  The caller names the
backend when it starts the world (``init_distributed``): ``nccl`` with
one device a rank, ``gloo`` on the CPU and for ranks that share a card.
``DeviceMesh`` gives a group per dim; ``pure_fsdp``'s batch runs over
both, so ``make_debug_mesh`` also starts one group over every rank of the
mesh, data-major (``flat_group``).
The 3-D ``("host", "data", "model")`` mesh and the production meshes are
not ported (ROADMAP.md A17).
"""
from __future__ import annotations

import os

import torch.distributed as dist

MESH_DIMS = ("data", "model")


def mesh_shape_for(devices: int, tp: int = 0) -> tuple[int, int]:
    """Pure (dp, tp) shape arithmetic for ``make_mesh_for``.

    tp=0 picks the largest power-of-two TP degree <= min(16, devices).
    Raises ValueError when an explicit tp does not divide devices:
    elastic restarts land on arbitrary survivor counts, so this must be a
    pointed error, not an assert."""
    if tp <= 0:
        tp = 1
        while tp * 2 <= min(16, devices) and devices % (tp * 2) == 0:
            tp *= 2
    dp, rem = divmod(devices, tp)
    if rem or dp < 1:
        raise ValueError(
            f"cannot build a (data={devices}/{tp}, model={tp}) mesh: "
            f"tp={tp} does not divide devices={devices}; pick a tp that "
            f"divides the surviving device count (or tp=0 to auto-select)")
    return dp, tp


def init_distributed(backend: str = "nccl", *,
                     init_method: str | None = None,
                     rank: int | None = None,
                     world_size: int | None = None) -> bool:
    """Start this process's rank of the world when running multi-process.

    Arguments left out are read from torchrun's environment: ``RANK``,
    ``WORLD_SIZE`` and ``tcp://MASTER_ADDR:MASTER_PORT``.  A no-op that
    returns False on one process with no ``init_method`` (a world of one
    needs no group unless the caller asks for one, as a (1, 1) mesh over
    NCCL does by passing ``init_method``); True once the group is up."""
    world_size = world_size if world_size is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None:
        return False
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        init_method = f"tcp://{addr}:{os.environ['MASTER_PORT']}"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return True


def make_debug_mesh(dp: int = 2, tp: int = 4, *,
                    device_type: str | None = None):
    """The (dp, tp) mesh over a started world of exactly dp * tp ranks
    (``init_distributed`` first).  ``device_type`` defaults to the
    backend's: ``cuda`` for nccl, ``cpu`` for gloo (ranks that share a
    card over gloo pass ``"cuda"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("start the world first: init_distributed(...)")
    if dist.get_world_size() != dp * tp:
        raise ValueError(
            f"a ({dp}, {tp}) mesh needs a world of {dp * tp} ranks, got "
            f"{dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, (dp, tp), mesh_dim_names=MESH_DIMS)
    # every rank starts it, in the same order, as it does the dims' groups
    mesh.repro_flat_group = dist.new_group(mesh.mesh.flatten().tolist())
    return mesh


def flat_group(mesh):
    """The group over every rank of a ``make_debug_mesh`` mesh, group rank
    i * tp + j at data position i and model position j."""
    group = getattr(mesh, "repro_flat_group", None)
    if group is None:
        raise ValueError("this mesh has no flat group: build it with "
                         "launch.mesh.make_debug_mesh")
    return group


def make_mesh_for(devices: int, tp: int = 0, *,
                  device_type: str | None = None):
    """Elastic helper: the best 2-D mesh for the world's ``devices``
    ranks; tp=0 picks the largest power-of-two TP degree <= min(16,
    devices)."""
    dp, tp = mesh_shape_for(devices, tp)
    return make_debug_mesh(dp, tp, device_type=device_type)
