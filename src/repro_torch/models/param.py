"""Parameter specifications: shapes + logical axes + initialiser.

The port's counterpart of ``repro.models.param``.  Models declare their
parameters as trees (dicts and lists) of ``Spec``; ``ParamTree`` turns such
a tree into an ``nn.Module`` whose parameters carry the tree's names
(``stack.layers.3.attn.wq``), and ``init_params`` fills them from a
``torch.Generator``.  Parameters are registered frozen, so serving builds
no autograd graph wherever it reads them; ``trainable()`` turns their
gradients on for training.  ``logical_axes()`` and ``abstract_params()``
give the parameters' logical axes and meta-device stand-ins by dotted
name, which ``launch.sharding`` maps to a mesh's layouts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis per dim (None: none)
    init: str = "normal"              # normal|zeros|ones|small|embed
    scale: float = 1.0
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _fan_in(shape):
    return shape[-2] if len(shape) >= 2 else shape[-1]


_STD = {"embed": 0.02, "small": 1e-3}


@torch.no_grad()
def _init_one(spec: Spec, out: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Fill ``out`` (of ``spec``'s shape and dtype) as the JAX package's
    initialiser does: zeros, ones, or an f32 normal draw times the std
    (``scale / sqrt(fan_in)`` for ``normal``) rounded to the dtype.  The
    draw comes from ``generator``, on ``out``'s device."""
    if spec.init == "zeros":
        return out.zero_()
    if spec.init == "ones":
        return out.fill_(1)
    if spec.init == "normal":
        std = spec.scale / math.sqrt(max(1, _fan_in(spec.shape)))
    elif spec.init in _STD:
        std = _STD[spec.init]
    else:
        raise ValueError(spec.init)
    draw = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                       device=out.device)
    return out.copy_(draw.mul_(std))


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def _leaves(tree) -> Iterator[Spec]:
    if is_spec(tree):
        yield tree
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
    else:
        for x in tree:
            yield from _leaves(x)


def param_count(tree) -> int:
    return sum(math.prod(s.shape) for s in _leaves(tree))


class ParamTree(nn.Module):
    """A dict of specs as a module: a ``Spec`` becomes a parameter (frozen
    until ``trainable()``), a dict a ``ParamTree``, a list an
    ``nn.ModuleList``.  ``tree["wq"]`` reads like the JAX package's
    parameter dicts.  Parameters are allocated, not initialised."""

    def __init__(self, tree: Dict[str, Any], device):
        super().__init__()
        self._specs: Dict[str, Spec] = {}
        for name, x in tree.items():
            if is_spec(x):
                self._specs[name] = x
                self.register_parameter(name, nn.Parameter(
                    torch.empty(x.shape, dtype=x.dtype, device=device),
                    requires_grad=False))
            elif isinstance(x, dict):
                self.add_module(name, ParamTree(x, device))
            else:
                self.add_module(name, nn.ModuleList(
                    ParamTree(t, device) for t in x))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._specs or name in self._modules

    def specs(self) -> Iterator[Tuple[Spec, torch.Tensor]]:
        """Every (spec, parameter) pair, in registration order."""
        for mod in self.modules():
            if isinstance(mod, ParamTree):
                for name, spec in mod._specs.items():
                    yield spec, getattr(mod, name)

    def named_specs(self) -> Iterator[Tuple[str, Spec]]:
        """Every (dotted name, spec), in ``named_parameters()``' order."""
        for prefix, mod in self.named_modules():
            if isinstance(mod, ParamTree):
                for name, spec in mod._specs.items():
                    yield (f"{prefix}.{name}" if prefix else name), spec

    def logical_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        return {n: s.axes for n, s in self.named_specs()}

    def abstract_params(self) -> Dict[str, torch.Tensor]:
        """Meta-device tensors of the parameters' shapes and dtypes."""
        return {n: torch.empty(s.shape, dtype=s.dtype, device="meta")
                for n, s in self.named_specs()}

    def trainable(self):
        """Turn every parameter's gradient on, as the trainer's
        ``launch.steps.init_train_state`` does."""
        return self.requires_grad_(True)

    def init_params(self, generator: Optional[torch.Generator] = None):
        """Initialise every parameter in place, one leaf at a time (so a
        full-width layer never draws more than one of its matrices at
        once), in registration order from ``generator``."""
        for spec, p in self.specs():
            _init_one(spec, p.data, generator)
        return self
