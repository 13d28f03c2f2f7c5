"""The sweep orchestrator's device mesh, PyTorch port of
``repro.launch.mesh.make_sweep_mesh`` / ``mesh_axes``.

Torch has no ``Mesh``: a ``SweepMesh`` is a ``(p, c)`` grid of
``torch.device``s with the axis names ``("params", "channel")``.  The
orchestrator splits a shard's params batch into ``p`` blocks and its
channels into ``c`` blocks; block ``(i, j)`` replays on ``devices[i, j]``
as one ``dram.resume`` call.  Lanes are independent, so placement is pure
layout and the result is bitwise the single-device replay.
"""
from __future__ import annotations

import dataclasses
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


def mesh_axes(mesh: SweepMesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))
