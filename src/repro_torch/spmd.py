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


def to_local(x: DTensor, grad_placements=None) -> torch.Tensor:
    """``x.to_local()``, its gradient contiguous; ``grad_placements`` says
    what the local gradient is (a ``Partial()`` where each rank's is a
    part of a sum), as ``DTensor.to_local``'s."""
    return _ContiguousGrad.apply(x.to_local(grad_placements=grad_placements))


def split_dim(mesh, name: str) -> Optional[int]:
    """The index of mesh dim ``name`` where it has more than one rank,
    else None (a dim of one rank splits nothing)."""
    names = mesh.mesh_dim_names
    if name not in names or mesh.shape[names.index(name)] == 1:
        return None
    return names.index(name)


def _all_to_all(x: torch.Tensor, out_splits, in_splits, group):
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_to_all_single(
        x.contiguous(), out_splits, in_splits, group))


def pair_plan(n: int, r: int):
    """``pair_halves``' all-to-all for rank r of n (n > 1) -> (swap, blocks
    sent to each rank, blocks received from each rank).  Rank r holds
    blocks 2r and 2r + 1 of the 2n column blocks of [gate | up]; block b
    is half b // n's slice b % n and goes to rank b % n, so its two blocks
    are sent in that order of ranks (swapped where it wraps).  Rank r
    takes its gate block from rank r // 2 and its up block from rank
    (n + r) // 2, gate first."""
    dest = [(2 * r) % n, (2 * r + 1) % n]
    return (dest[0] > dest[1], [dest.count(k) for k in range(n)],
            [int(k in (r // 2, (n + r) // 2)) for k in range(n)])


class _PairHalves(torch.autograd.Function):
    """``pair_halves``' all-to-all; its backward sends the gradient back
    with the reverse one."""

    @staticmethod
    def forward(ctx, t, group, n: int, r: int):
        ctx.swap, ctx.ins, ctx.outs = pair_plan(n, r)
        ctx.group = group
        blocks = t.unflatten(-1, (2, t.shape[-1] // 2)).movedim(-2, 0)
        if ctx.swap:
            blocks = blocks.flip(0)
        out = _all_to_all(blocks, ctx.outs, ctx.ins, group)
        return out.movedim(0, -2).flatten(-2)

    @staticmethod
    def backward(ctx, g):
        blocks = g.unflatten(-1, (2, g.shape[-1] // 2)).movedim(-2, 0)
        back = _all_to_all(blocks, ctx.ins, ctx.outs, ctx.group)
        if ctx.swap:
            back = back.flip(0)
        return back.movedim(0, -2).flatten(-2), None, None, None


def pair_halves(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """t (..., 2w), this rank's slice of a [gate | up] last dim split in
    equal parts over mesh dim ``dim`` (so a rank holds gate columns, up
    columns, or, for an odd count, some of each) -> (..., 2w) = [gate_j |
    up_j], the j-th w-wide slice of each half on rank j.  One all-to-all
    over the mesh dim moves each rank's two blocks; no rank gathers more
    than its own 2w columns."""
    return _PairHalves.apply(t, mesh.get_group(dim), mesh.shape[dim],
                             mesh.get_local_rank(dim))


class _GradOnFirst(torch.autograd.Function):
    """The identity, whose gradient is kept on the first rank of a group
    and zeroed on the others."""

    @staticmethod
    def forward(ctx, x, keep: bool):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


def grad_once(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """x, a value every rank of mesh dim ``dim`` computes alike, whose
    gradient is to join a sum over that dim's ranks: the gradient is kept
    on its first rank only, so the sum counts it once."""
    return _GradOnFirst.apply(x, mesh.get_local_rank(dim) == 0)


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
                              stride=contiguous_stride(shape))


def contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))
