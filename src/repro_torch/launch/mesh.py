"""Device meshes, the port of ``repro.launch.mesh``.

The LM stack's meshes (``make_production_mesh``, ``make_test_mesh``) are
``torch.distributed.device_mesh.DeviceMesh``es with the reference's axis
names (``"data"``, ``"model"``, and ``"pod"`` on two pods).  A
``DeviceMesh`` needs an initialised process group: the functions raise
without one and never create one.  ``init_single`` makes the one-process
group (world size 1, a ``FileStore`` in a fresh temporary directory: no
socket, no environment variables) and ``init_fake`` the ``fake``
backend's group of any world size, on which the dry run lays out a
256-rank mesh in one process; a real multi-rank group is the caller's
(``torch.distributed.init_process_group`` with its address, world size
and rank).  ``set_mesh`` is the reference's context for a mesh; the port
lays every tensor out explicitly, so nothing reads it.

Torch has no ``Mesh`` for the sweep orchestrator either: a ``SweepMesh``
is a ``(p, c)`` grid of ``torch.device``s with the axis names
``("params", "channel")``.  The
orchestrator splits a shard's params batch into ``p`` blocks and its
channels into ``c`` blocks; block ``(i, j)`` replays on ``devices[i, j]``
as one ``dram.resume`` call.  Lanes are independent, so placement is pure
layout and the result is bitwise the single-device replay.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SweepMesh:
    """``devices`` is a ``(p, c)`` object array of ``torch.device``."""
    devices: np.ndarray
    axis_names: tuple = ("params", "channel")


def _cuda_devices():
    resolve_device(None)                 # raises without CUDA
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_sweep_mesh(n_params: int, n_channels: int,
                    devices: Optional[Sequence] = None) -> SweepMesh:
    """("params", "channel") mesh for the sharded sweep orchestrator.

    Axis sizes are the largest divisors of the batch extents that fit the
    available device count, so every block divides evenly (no padding) and
    placement stays a pure layout decision.  ``devices=None`` takes every
    CUDA device; one device gives the (1, 1) mesh, the unsharded replay.
    """
    devs = [torch.device(d) for d in
            (_cuda_devices() if devices is None else devices)]

    def best_divisor(n: int, cap: int) -> int:
        for d in range(min(n, cap), 0, -1):
            if n % d == 0:
                return d
        return 1

    p = best_divisor(max(n_params, 1), len(devs))
    c = best_divisor(max(n_channels, 1), len(devs) // p)
    grid = np.empty((p, c), dtype=object)
    for k, dev in enumerate(devs[:p * c]):
        grid[k // c, k % c] = dev
    return SweepMesh(grid)


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``SweepMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, SweepMesh):
        return dict(zip(mesh.axis_names, mesh.devices.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# --------------------------------------------------------------------------
# The LM stack's meshes
# --------------------------------------------------------------------------

def init_single(device_type: str = "cuda"):
    """Initialise the one-process group: world size 1, rank 0, ``nccl`` for
    ``"cuda"`` (on device 0) and ``gloo`` otherwise, its store a file in a
    fresh temporary directory.  Raises if a group exists."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    if device_type == "cuda":
        resolve_device(None)
        torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=store, rank=0, world_size=1)


def init_fake(world: int):
    """Initialise the ``fake`` backend's group of ``world`` ranks in this
    one process (rank 0): its collectives move nothing, so it serves the
    dry run's layouts on the meta device.  Raises if a group exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _device_mesh(device_type: str, shape: tuple, names: tuple):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            "a DeviceMesh needs an initialised process group: call "
            "mesh.init_single() / init_fake(world), or "
            "torch.distributed.init_process_group yourself")
    if dist.get_world_size() == math.prod(shape):
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    # the first ranks of a larger group (the dry run's 16 x 16 mesh on a
    # 512-rank fake group)
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.arange(math.prod(shape)).view(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model"): 256 or 512 ranks in the current group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(device_type, shape, axes)


def make_test_mesh(dp: int = 1, tp: int = 1, *, device_type: str = "cuda"):
    """A (dp, tp) ("data", "model") mesh over the current group's
    ``dp * tp`` ranks."""
    return _device_mesh(device_type, (dp, tp), ("data", "model"))


def dp_axes(mesh):
    """Axes used for data parallelism (batch + ZeRO)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


@contextlib.contextmanager
def set_mesh(mesh):
    """The reference's mesh context, here the identity: the port's
    tensors carry their mesh (``DTensor``), so nothing reads a current
    one."""
    yield mesh
