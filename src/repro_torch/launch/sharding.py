"""Logical-axis -> mesh-axis mapping, the port of
``repro.launch.sharding``.

Parameters carry logical axis names (``models/param.Spec``); this module
maps them to the mesh's axes:

  TP  ("model"):  vocab, ffn, q_heads, kv_heads, q_heads_flat, experts' ffn
  DP  ("pod","data"): batch dim of activations; ZeRO-1/2 optimizer/grad shards
  SP  ("model"): sequence dim of inter-layer activations (Megatron-SP)

A spec is the reference's ``PartitionSpec`` as a tuple
(``repro_torch.spmd``); a ``NamedSharding`` pairs it with a
``DeviceMesh`` and gives its
``DTensor`` placements and its shard shape.  The trees are the port's:
parameters and optimizer leaves are dicts keyed by the parameters' dotted
names, one entry per layer.  The reference stacks each scan group's
leaves on a leading "layers" axis, which ZeRO-1 may split (the first
replicated DP-divisible dim); the port's leaves are per layer, so ZeRO-1
takes the first such dim of the layer's own leaf.  Where the layer axis
was the reference's choice, the per-device bytes are the same whenever
the layer's leaf has a divisible dim.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence

from repro_torch.launch.mesh import dp_axes, mesh_axes
from repro_torch.spmd import placements as _placements
from repro_torch.spmd import shard_shape as _shard_shape

LOGICAL_TO_MESH = {
    "vocab": "model",
    "ffn": "model",
    "q_heads": "model",
    "kv_heads": "model",
    "q_heads_flat": "model",
    "embed": None,
    "embed_tp": "model",  # untied input-embedding table: shard d, not vocab
    "vocab_in": None,
    "layers": None,
    "experts": None,      # expert weights shard on their ffn dim instead
    "kv_lora": None,
    "head_dim": None,
    None: None,
}

# FSDP shards a parameter over the data axes from this many elements on
FSDP_MIN = 1 << 20


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: ``placements`` for ``DTensor``,
    ``shard_shape(shape)`` for the local shard."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return _placements(self.spec, self.mesh)

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        return _shard_shape(shape, self.spec, self.mesh)


def dp_size(mesh) -> int:
    ax = mesh_axes(mesh)
    return math.prod(ax[a] for a in dp_axes(mesh))


def _dp_entry(mesh):
    dp = dp_axes(mesh)
    return dp[0] if len(dp) == 1 else dp


def param_pspec(axes: tuple) -> tuple:
    return tuple(LOGICAL_TO_MESH.get(a) for a in axes)


def zero1_pspec(axes: tuple, shapes: tuple, dp_size: int) -> tuple:
    """Optimizer-state spec: param spec + DP shard on the first
    replicated, DP-divisible dim (ZeRO-1)."""
    spec = [LOGICAL_TO_MESH.get(a) for a in axes]
    for i, (m, s) in enumerate(zip(spec, shapes)):
        if m is None and s % dp_size == 0 and s >= dp_size:
            spec[i] = ("pod", "data") if dp_size > 16 else "data"
            break
    return tuple(spec)


def stack_counts(cfg) -> Dict[str, int]:
    """{layer prefix: layers in its scan group} for the reference's
    stacked leaves: ``stack.layers.<i>.`` -> the count of the group
    holding layer i (1 where the reference keeps a group of one
    unstacked), Whisper's ``enc.<i>.`` / ``dec.<i>.`` -> its encoder /
    decoder depth."""
    if cfg.is_encdec:
        out = {f"enc.{i}.": cfg.encoder_layers
               for i in range(cfg.encoder_layers)}
        out.update({f"dec.{i}.": cfg.n_layers for i in range(cfg.n_layers)})
        return out
    from repro_torch.models.transformer import group_layout
    out, i = {}, 0
    for count, block in group_layout(cfg):
        for _ in range(count * len(block)):
            out[f"stack.layers.{i}."] = count
            i += 1
    return out


def _stacked_numel(name: str, shape, counts: Optional[Mapping[str, int]]):
    """Elements of the reference's leaf for ``name``: the layer's leaf
    times its scan group's count."""
    n = math.prod(shape) if shape else 0
    if counts:
        for prefix, c in counts.items():
            if name.startswith(prefix):
                return n * c
    return n


def param_shardings(logical: Mapping[str, tuple], mesh, *,
                    fsdp: bool = False,
                    abstract: Optional[Mapping[str, Any]] = None,
                    counts: Optional[Mapping[str, int]] = None
                    ) -> Dict[str, NamedSharding]:
    """{name: sharding} of the parameters.  ``fsdp`` (ZeRO-3) also shards
    every leaf of at least 2^20 elements as ZeRO-1 does (``abstract``
    gives the shapes); with ``counts`` (``stack_counts``) a layer's leaf
    is sized as the reference's stacked leaf, so the same leaves shard."""
    if not fsdp:
        return {n: NamedSharding(mesh, param_pspec(ax))
                for n, ax in logical.items()}
    assert abstract is not None
    dp = dp_size(mesh)
    out = {}
    for n, ax in logical.items():
        shape = tuple(abstract[n].shape)
        big = _stacked_numel(n, shape, counts) >= FSDP_MIN
        out[n] = NamedSharding(mesh, zero1_pspec(ax, shape, dp) if big
                               else param_pspec(ax))
    return out


def zero1_shardings(logical: Mapping[str, tuple],
                    abstract: Mapping[str, Any], mesh
                    ) -> Dict[str, NamedSharding]:
    dp = dp_size(mesh)
    return {n: NamedSharding(mesh, zero1_pspec(ax, tuple(abstract[n].shape),
                                               dp))
            for n, ax in logical.items()}


def batch_pspec(mesh, *, seq_sharded: bool = False) -> tuple:
    """(B, S, ...) activations: batch over DP; optionally seq over model."""
    return (_dp_entry(mesh), "model" if seq_sharded else None)


def data_shardings(batch: Mapping[str, Any], mesh
                   ) -> Dict[str, NamedSharding]:
    """Every batch leaf's dim 0 over DP (``positions3`` (3, B, S): dim 1)."""
    dp = _dp_entry(mesh)
    out = {}
    for k, leaf in batch.items():
        if leaf.dim() >= 1 and leaf.shape[0] == 3:   # positions3 (3,B,S)
            out[k] = NamedSharding(mesh, (None, dp))
        else:
            out[k] = NamedSharding(mesh, (dp,) + (None,) * (leaf.dim() - 1))
    return out


def cache_shardings(caches: Any, mesh, *, seq_shard: bool = False) -> Any:
    """Shardings of decode caches, in the caches' own structure: each
    ``KVCache`` / ``MambaState`` / ``RWKVState`` of the per-layer list, and
    Whisper's ``WhisperCache`` (its cross-attention K/V, one (B, F, H, D)
    tensor per layer).  A KV cache's length (a Python int) is replicated.

    Default: batch over DP, kv heads over model where they divide.
    ``seq_shard`` (long context, global batch 1): the KV sequence over DP
    instead; recurrent states replicate over DP."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.mamba import MambaState
    from repro_torch.models.rwkv6 import RWKVState
    from repro_torch.models.whisper import WhisperCache
    dp = _dp_entry(mesh)
    tp = mesh_axes(mesh)["model"]

    def ns(*spec):
        return NamedSharding(mesh, tuple(spec))

    def model_if(h):
        return "model" if h % tp == 0 and h >= tp else None

    def kv_leaf(a, ndim: int):
        """(B, S, H, D) pools or (B, S, H) scales."""
        model = model_if(a.shape[2])
        b, s = (None, dp) if seq_shard else (dp, None)
        return ns(b, s, model, *((None,) if ndim == 4 else ()))

    def cross(a):                     # (B, F, H, D)
        return ns(None if seq_shard else dp, None, model_if(a.shape[2]),
                  None)

    def visit(node):
        if isinstance(node, KVCache):
            return KVCache(
                k=kv_leaf(node.k, 4), v=kv_leaf(node.v, 4),
                k_scale=None if node.k_scale is None
                else kv_leaf(node.k_scale, 3),
                v_scale=None if node.v_scale is None
                else kv_leaf(node.v_scale, 3),
                length=ns())
        if isinstance(node, MambaState):
            b = None if seq_shard else dp
            return MambaState(conv=ns(b, None, "model"),
                              ssm=ns(b, "model", None))
        if isinstance(node, RWKVState):
            b = None if seq_shard else dp
            hm = "model" if node.wkv.shape[-3] % tp == 0 else None
            return RWKVState(x_tm=ns(b, None), x_cm=ns(b, None),
                             wkv=ns(b, hm, None, None))
        if isinstance(node, WhisperCache):
            ks, vs = node.cross
            return WhisperCache([visit(c) for c in node.self_kv],
                                ([cross(a) for a in ks],
                                 [cross(a) for a in vs]))
        if isinstance(node, (list, tuple)):
            return type(node)(visit(x) for x in node)
        return ns()

    return visit(caches)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())
