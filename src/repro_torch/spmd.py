"""Layouts of tensors on a device mesh: the port's form of GSPMD's
``PartitionSpec``.

A *spec* is the reference's ``PartitionSpec`` as a plain tuple, one entry
per tensor dim: a mesh axis name, a tuple of names (the dim split over
those axes, major to minor) or None (not split).  ``placements`` turns it
into the ``DTensor`` placements of a ``DeviceMesh``; ``constrain`` is
``with_sharding_constraint``: it redistributes a ``DTensor`` and returns a
plain tensor unchanged, so the one-device path never sees a mesh.

A hand-written kernel writes through raw pointers, and a ``DTensor`` has
no storage of its own: ``local_call`` runs such a function on the local
shards, after redistributing its inputs so that only the dims it may see
split are split (the batch and the heads of attention), and wraps the
result back with the inputs' placements.  Every op is per (batch, head),
so the local result is the global one restricted to the shard.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: Sequence, mesh) -> tuple:
    """``Shard(d)`` on every mesh dim that tensor dim ``d``'s entry names,
    ``Replicate()`` on the others.  An entry naming several axes splits
    its dim over each of them in mesh-dim order, which is the reference's
    major-to-minor order.  An axis the mesh lacks, or of size 1, leaves
    its mesh dim replicated: split one way, a dim is whole."""
    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for a in _names(entry):
            if a in names and mesh.shape[names.index(a)] > 1:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def shard_shape(shape: Sequence[int], spec: Sequence, mesh) -> Tuple[int, ...]:
    """The local shape of rank 0's shard: each split dim divided (rounded
    up, as ``torch.chunk``) by the product of its axes' sizes."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _names(entry):
            if a in sizes:
                out[d] = -(-out[d] // sizes[a])
    return tuple(out)


def constrain(x, spec: Optional[Sequence]):
    """``with_sharding_constraint``: a ``DTensor`` redistributed to
    ``spec``'s placements (a pending sum reduced on the way); a plain
    tensor, or a None spec, returns ``x`` as it is."""
    if spec is None or not is_dtensor(x):
        return x
    want = placements(tuple(spec) + (None,) * (x.dim() - len(spec)),
                      x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def _allowed(x: DTensor, dims: Sequence[int]) -> tuple:
    """x's placements with every split outside ``dims`` (and every
    pending sum) replaced by ``Replicate()``."""
    return tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate()
                 for p in x.placements)


def redistribute_to(x, want: tuple):
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(x.device_mesh, want)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: a ``DTensor``
    built from a local gradient takes its global strides from the shape,
    so a strided local gradient (a permuted view) would break the next
    view of it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def to_local(x: DTensor) -> torch.Tensor:
    """``x.to_local()``, its gradient contiguous."""
    return _ContiguousGrad.apply(x.to_local())


def local_call(fn: Callable, args: Sequence, dims: Sequence[int]):
    """``fn(*locals)`` where ``args`` holds ``DTensor``s: each is
    redistributed so that only ``dims`` may stay split (the first
    argument's splits decide, and every other argument takes the same
    placements), then taken local; the result (a tensor) is wrapped back
    with those placements and the first argument's global shape in the
    split dims.  Plain tensors in ``args`` pass through, so on one device
    this is ``fn(*args)``."""
    lead = args[0]
    if not is_dtensor(lead):
        return fn(*args)
    want = _allowed(lead, dims)
    loc = [to_local(redistribute_to(a, want)) if is_dtensor(a) else a
           for a in args]
    out = fn(*loc).contiguous()
    shape = list(lead.shape[:out.dim()])
    for d in range(out.dim()):
        if not any(isinstance(p, Shard) and p.dim == d for p in want):
            shape[d] = out.shape[d]
    return DTensor.from_local(out, lead.device_mesh, want, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))
