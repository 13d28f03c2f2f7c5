"""Carry state between the JAX package and the PyTorch port.

A simulator has no weights; what a replay carries is its config's numeric
knobs (``MechParams``) and its scan state (``SimState``).  FIGCache-KV
carries its ``FigKVState`` and an embedding cache its ``EmbedCache``.
A model carries its parameters and its decode caches (KV caches, Mamba's
and RWKV's recurrent states).  These helpers take
them as numpy arrays — the JAX package's leaves after ``np.asarray`` — so
a run started in one package can finish in the other.  Nothing here
imports the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import dram
from repro_torch.core import fts as fts_lib
from repro_torch.core.timing import MechParams
from repro_torch.device import resolve_device
from repro_torch.figkv import EmbedCache, FigKVState
from repro_torch.models import transformer, whisper
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba import MambaState
from repro_torch.models.rwkv6 import RWKVState

# unbatched rank and dtype of every SimState leaf, in the JAX package's
# tree-leaves order (NamedTuple fields depth first)
_BANK_LEAVES = (
    ("open_row", 1, torch.int32), ("busy", 1, torch.int32),
    ("tags", 1, torch.int32), ("valid", 1, torch.bool),
    ("dirty", 1, torch.bool), ("benefit", 1, torch.int32),
    ("last_use", 1, torch.int32), ("evict_row", 0, torch.int32),
    ("evict_mask", 1, torch.bool), ("miss_tags", 1, torch.int32),
    ("miss_cnt", 1, torch.int32), ("row_sum", 1, torch.int32),
    ("free_list", 1, torch.int32), ("n_valid", 0, torch.int32),
    ("mshr_ring", 2, torch.int32), ("mshr_idx", 1, torch.int32),
    ("bus_free", 0, torch.int32),
)
# the FTS leaves carry a bank axis on top of their own rank
_FTS_NAMES = set(fts_lib.FTS._fields)
_CNT_RANK = {f: (1 if f in ("lat_sum_ns", "req_cnt") else 0)
             for f in dram.Counters._fields}


def mech_params_from_numpy(params: Mapping[str, object],
                           device=None) -> MechParams:
    """``{field: array}`` (0-d or ``(P,)``) -> ``MechParams`` of int32
    tensors, e.g. from the JAX package's ``cfg.params()._asdict()``."""
    dev = resolve_device(device)
    return MechParams(**{
        f: torch.tensor(np.asarray(params[f]), dtype=torch.int32,
                        device=dev)
        for f in MechParams._fields})


def _to_lanes(x, rank: int, dtype, device) -> torch.Tensor:
    a = np.asarray(x)
    extra = a.ndim - rank
    if extra < 0:
        raise ValueError(f"leaf of shape {a.shape} has fewer than {rank} "
                         "axes")
    lanes = math.prod(a.shape[:extra])
    a = np.array(a.reshape((lanes,) + a.shape[extra:]))  # own, writable
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def sim_state_from_numpy(bank_leaves: Sequence, cnt_leaves: Sequence,
                         device=None) -> dram.SimState:
    """The JAX package's ``SimState`` leaves as numpy arrays -> the port's
    ``SimState``.

    ``bank_leaves`` are ``jax.tree.leaves(state.bank)`` (17 arrays) and
    ``cnt_leaves`` ``jax.tree.leaves(state.cnt)`` (12), in that order.  Any
    leading axes beyond a leaf's own rank — none for one channel, ``(C,)``
    or ``(P, C)`` for batched states — flatten into the port's lane axis
    (lane ``p * C + c``)."""
    dev = resolve_device(device)
    if len(bank_leaves) != len(_BANK_LEAVES):
        raise ValueError(f"expected {len(_BANK_LEAVES)} bank leaves, got "
                         f"{len(bank_leaves)}")
    if len(cnt_leaves) != len(dram.Counters._fields):
        raise ValueError(f"expected {len(dram.Counters._fields)} counter "
                         f"leaves, got {len(cnt_leaves)}")
    bank: Dict[str, torch.Tensor] = {}
    for (name, rank, dtype), x in zip(_BANK_LEAVES, bank_leaves):
        rank += 1 if name in _FTS_NAMES else 0   # (n_banks, ...) per lane
        bank[name] = _to_lanes(x, rank, dtype, dev)
    cnt = {f: _to_lanes(x, _CNT_RANK[f], torch.int32, dev)
           for f, x in zip(dram.Counters._fields, cnt_leaves)}
    lanes = {x.shape[0] for x in list(bank.values()) + list(cnt.values())}
    if len(lanes) != 1:
        raise ValueError(f"leaves disagree on the lane count: {lanes}")
    fts = fts_lib.FTS(**{f: bank.pop(f) for f in fts_lib.FTS._fields})
    return dram.SimState(bank=dram.BankState(fts=fts, **bank),
                         cnt=dram.Counters(**cnt))


def counters_to_numpy(cnt: dram.Counters) -> Dict[str, np.ndarray]:
    """``Counters`` -> ``{field: numpy array}`` (copies to the host)."""
    return {f: x.detach().cpu().numpy() for f, x in zip(cnt._fields, cnt)}


def _tensor(x, device) -> torch.Tensor:
    """A numpy array (bf16 ones too, as the JAX package hands them out) ->
    a tensor of the same dtype that owns its memory."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def figkv_state_from_numpy(leaves: Sequence, device=None) -> FigKVState:
    """The JAX package's ``jax.tree.leaves(FigKVState)`` as numpy arrays ->
    the port's ``FigKVState``, so a decode started in one package can
    continue in the other: pool_k, pool_v, seg_key, fast_k, fast_v, the 12
    FTS leaves (leading batch axis), length."""
    dev = resolve_device(device)
    n_fts = len(fts_lib.FTS._fields)
    if len(leaves) != 6 + n_fts:
        raise ValueError(f"expected {6 + n_fts} FigKVState leaves, got "
                         f"{len(leaves)}")
    t = [_tensor(x, dev) for x in leaves[:5 + n_fts]]
    return FigKVState(*t[:5], fts=fts_lib.FTS(*t[5:]),
                      length=int(np.asarray(leaves[-1])))


def embed_cache_from_numpy(leaves: Sequence, device=None) -> EmbedCache:
    """The JAX package's ``jax.tree.leaves(EmbedCache)`` as numpy arrays ->
    the port's ``EmbedCache``: fast, the 12 FTS leaves (one store, which
    gains the port's lane axis), hits, lookups."""
    dev = resolve_device(device)
    n_fts = len(fts_lib.FTS._fields)
    if len(leaves) != 3 + n_fts:
        raise ValueError(f"expected {3 + n_fts} EmbedCache leaves, got "
                         f"{len(leaves)}")
    t = [_tensor(x, dev) for x in leaves]
    return EmbedCache(fast=t[0], fts=fts_lib.FTS(*[x[None] for x in
                                                    t[1:1 + n_fts]]),
                      hits=t[-2], lookups=t[-1])


def _sel(a, i):
    """A leaf as a numpy array, at ``i`` on a stacked group's layer axis
    (whole when ``i`` is None)."""
    a = np.asarray(a)
    return a if i is None else a[i]


def _layers(cfg, groups) -> Iterator[Tuple[object, object, object]]:
    """(group entry, index or None, ``LayerDef``) of every layer, in layer
    order, over the JAX package's scan groups: a group of ``count`` > 1
    identical blocks (Jamba's: an 8-layer period) stacks its leaves on a
    leading axis, a group of one does not."""
    layout = transformer.group_layout(cfg)
    if len(groups) != len(layout):
        raise ValueError(f"expected {len(layout)} layer groups, got "
                         f"{len(groups)}")
    for (count, block), group in zip(layout, groups):
        for i in range(count):
            for j, d in enumerate(block):
                yield group[j], (i if count > 1 else None), d


def _flat(tree, prefix: str) -> Iterator[Tuple[str, object]]:
    if isinstance(tree, Mapping):
        for name, x in tree.items():
            yield from _flat(x, f"{prefix}{name}.")
    else:
        yield prefix[:-1], tree


def _stacked(tree, prefix: str, count: int, dev
             ) -> Iterator[Tuple[str, torch.Tensor]]:
    """A stack of ``count`` layers whose leaves carry a leading layer axis
    -> one ``{prefix}.{i}.{path}`` entry per layer and leaf."""
    for path, x in _flat(tree, ""):
        a = np.asarray(x)
        for i in range(count):
            yield f"{prefix}.{i}.{path}", _tensor(a[i], dev)


def model_params_from_numpy(cfg, tree: Mapping, device=None
                            ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``Model`` params as numpy arrays (``jax.tree.map(
    np.asarray, params)``: nested dicts and lists, scan groups stacked on a
    leading layer axis) -> the state of the port's ``Model`` for ``cfg``
    (``model.load_state_dict(...)``), one entry per layer.  Whisper's tree
    is ``enc`` / ``dec`` (each stacked), ``enc_ln``, ``dec_ln``,
    ``tok_embed`` and ``pos_embed``."""
    dev = resolve_device(device)
    if cfg.is_encdec:
        out = dict(_stacked(tree["enc"], "enc", cfg.encoder_layers, dev))
        out.update(_stacked(tree["dec"], "dec", cfg.n_layers, dev))
        for name in ("enc_ln", "dec_ln"):
            out.update((f"{name}.{k}", _tensor(x, dev))
                       for k, x in tree[name].items())
        for name in ("tok_embed", "pos_embed"):
            out[name] = _tensor(tree[name], dev)
        return out
    out = {"tok_embed": _tensor(tree["tok_embed"], dev),
           "stack.ln_f": _tensor(tree["stack"]["ln_f"], dev)}
    if "lm_head" in tree:
        out["lm_head"] = _tensor(tree["lm_head"], dev)
    for n, (layer, i, _) in enumerate(_layers(cfg,
                                              tree["stack"]["groups"])):
        for path, x in _flat(layer, ""):
            out[f"stack.layers.{n}.{path}"] = _tensor(_sel(x, i), dev)
    return out


def _kv_cache(c, i, dev) -> KVCache:
    """One layer's ``KVCache`` from a JAX KVCache tuple of numpy arrays,
    its leaves indexed at ``i`` on a stacked group's layer axis (or
    taken whole when ``i`` is None); an int8 cache's scales come along."""
    k, v, k_scale, v_scale, length = c
    scales = (None, None) if k_scale is None else \
        (_tensor(_sel(k_scale, i), dev), _tensor(_sel(v_scale, i), dev))
    return KVCache(_tensor(_sel(k, i), dev), _tensor(_sel(v, i), dev),
                   *scales, length=int(_sel(length, i)))


def _layer_cache(c, i, d, dev):
    """One layer's cache by its mixer: a Mamba layer's ``(conv, ssm)``
    becomes a ``MambaState``, an RWKV layer's ``(x_tm, x_cm, wkv)`` an
    ``RWKVState``, anything else a ``KVCache``."""
    state = {"mamba": MambaState, "rwkv": RWKVState}.get(d.mixer)
    if state is None:
        return _kv_cache(c, i, dev)
    return state(*[_tensor(_sel(a, i), dev) for a in c])


def kv_caches_from_numpy(cfg, tree: Sequence, device=None):
    """The JAX package's decode caches as numpy arrays (``jax.tree.map(
    np.asarray, caches)``: one list per scan group of each layer's cache
    tuple, stacked on a leading axis in a group of ``count`` > 1) -> the
    port's per-layer caches, so a JAX prefill can continue in the port's
    decode.  A KVCache ``(k, v, k_scale, v_scale, length)`` (an int8 cache
    with its codes and f32 scales, an MLA layer's latent cache with c_kv in
    k and the RoPE key in v, a sliding-window ring with its length past its
    slots), a ``MambaState`` ``(conv, ssm)`` and an ``RWKVState`` ``(x_tm,
    x_cm, wkv)`` carry over as they are.  Whisper's ``(caches, (cross_k,
    cross_v))``, each stacked over the decoder layers, becomes a
    ``WhisperCache``."""
    dev = resolve_device(device)
    if cfg.is_encdec:
        caches, (ck, cv) = tree
        cross = tuple([_tensor(np.asarray(a)[i], dev)
                       for i in range(cfg.n_layers)] for a in (ck, cv))
        return whisper.WhisperCache(
            [_kv_cache(caches, i, dev) for i in range(cfg.n_layers)], cross)
    return [_layer_cache(c, i, d, dev) for c, i, d in _layers(cfg, tree)]
