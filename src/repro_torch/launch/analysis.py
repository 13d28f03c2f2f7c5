"""Roofline terms of a traced step, the port of ``repro.launch.analysis``.

Hardware model: the H100 SXM's published peaks (the ``hopper-kernels``
guide; not measurements): 989e12 FLOP/s dense bf16, 3.35e12 B/s HBM3 and
450e9 B/s NVLink each way, at the 700 W power limit.  ``roofline`` takes
the three as keyword arguments, so the reference's TPU v5e constants
(197e12 / 819e9 / 50e9) give its numbers.

  compute term    = FLOPs / peak_FLOPs          (per rank)
  memory term     = bytes / HBM_bw
  collective term = sum of bytes(op) * algo_factor / link_bw

The reference reads XLA's cost analysis and parses the partitioned HLO
text; the port traces one step instead (``launch.dryrun``): ``Trace`` is a
``TorchDispatchMode`` that sees each rank's local aten ops (the ops a
``DTensor`` runs on its shards), counts their FLOPs with PyTorch's FLOP
formulas, their bytes as each op's inputs read once and outputs written
once (the eager port runs op by op), and the per-rank result bytes of the
collectives by kind; all-reduce counts twice (reduce-scatter + all-gather
phases).  ``Trace.log`` keeps each collective's kind, its input and result
shapes, result bytes and process group's name, in the order they ran.  The
reference's ``scan_corrections`` has no counterpart: XLA's cost model
counts a ``while`` body once, but the port's trace runs every trip of its
Python loops (attention's query blocks and KV chunks, the recurrences'
tokens, the microbatches) and counts each.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = 989e12      # H100 SXM, dense bf16 (published)
HBM_BW = 3.35e12         # H100 SXM HBM3 (published)
LINK_BW = 450e9          # H100 NVLink, each way (published)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_FACTOR = {"all-reduce": 2.0}
_KIND = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
         ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
         ("broadcast", "collective-permute"),
         ("permute", "collective-permute"))
_NO_BYTES = ("view", "_unsafe_view", "reshape", "expand", "t", "transpose",
             "permute", "alias", "detach", "slice", "select", "unsqueeze",
             "squeeze", "as_strided", "split", "chunk", "unbind",
             "empty", "empty_strided", "empty_like")


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class Trace(TorchDispatchMode):
    """Per-rank FLOPs, bytes and collective bytes of the local ops run
    inside it.  An op on ``DTensor``s is left to the ``DTensor`` (which
    runs local ops, counted here), and the fake-tensor ops by which
    ``DTensor`` propagates global shapes are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.coll: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
        self.coll["count"] = 0
        self.log: List[Dict[str, Any]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(a, FakeTensor) for a in flat):
            return out
        pkt = func._overloadpacket
        name = pkt.__name__
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            for key, kind in _KIND:
                if key in name:
                    res = [t for t in tree_flatten(out)[0]
                           if isinstance(t, torch.Tensor)]
                    self.coll[kind] += sum(_nbytes(t) for t in res)
                    self.coll["count"] += 1
                    names = [a for a in flat if isinstance(a, str)]
                    self.log.append({
                        "kind": kind,
                        "in": [list(a.shape) for a in flat
                               if isinstance(a, torch.Tensor)],
                        "out": [list(t.shape) for t in res],
                        "bytes": sum(_nbytes(t) for t in res),
                        "group": names[-1] if names else None})
                    break
            return out
        self.ops += 1
        if pkt in self._flop_registry:
            self.flops += self._flop_registry[pkt](*args, **kwargs,
                                                   out_val=out)
        if name.rstrip("_") not in _NO_BYTES:
            self.bytes += sum(_nbytes(a) for a in flat) + sum(
                _nbytes(t) for t in tree_flatten(out)[0])
        return out

    def cost(self) -> Dict[str, float]:
        return {"flops": float(self.flops), "bytes accessed":
                float(self.bytes), "ops": float(self.ops)}

    def collectives(self) -> Dict[str, float]:
        out = dict(self.coll)
        out["total_bytes"] = sum(out[k] for k in _COLLECTIVES)
        out["weighted_bytes"] = sum(out[k] * _FACTOR.get(k, 1.0)
                                    for k in _COLLECTIVES)
        return out


def by_shape(log: List[Dict[str, Any]], top: int = 16) -> List[list]:
    """``Trace.log`` grouped by kind, input and result shapes -> the
    ``top`` groups with the most result bytes, each ``[kind, input
    shapes, result shapes, count, result bytes]``."""
    groups: Dict[tuple, list] = {}
    for rec in log:
        key = (rec["kind"], str(rec["in"]), str(rec["out"]))
        g = groups.setdefault(key, [rec["kind"], rec["in"], rec["out"], 0, 0])
        g[3] += 1
        g[4] += rec["bytes"]
    return sorted(groups.values(), key=lambda g: -g[4])[:top]


def collective_bytes(fn, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` under ``Trace`` -> per-rank bytes by
    collective kind, ``count``, ``total_bytes`` and ``weighted_bytes``
    (the reference's keys)."""
    with Trace() as t:
        fn(*args, **kwargs)
    return t.collectives()


def roofline(cost: dict, coll: Dict[str, float], *, n_devices: int,
             model_flops: float,
             corrections: Optional[Dict[str, float]] = None,
             peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
             link_bw: float = LINK_BW) -> dict:
    """Per-device roofline terms (seconds) + useful-compute ratio."""
    corrections = corrections or {"extra_flops": 0.0, "extra_bytes": 0.0,
                                  "microbatch_scale": 1.0}
    mb = corrections["microbatch_scale"]
    flops = float(cost.get("flops", 0.0)) * mb + corrections["extra_flops"]
    bytes_acc = float(cost.get("bytes accessed", 0.0)) * mb \
        + corrections["extra_bytes"]
    t_compute = flops / peak_flops
    t_memory = bytes_acc / hbm_bw
    t_coll = coll["weighted_bytes"] * mb / link_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    bottleneck = max(terms, key=terms.get)
    mf_per_dev = model_flops / n_devices
    return {
        **terms,
        "bottleneck": bottleneck,
        "hlo_flops_per_dev": flops,
        "hlo_bytes_per_dev": bytes_acc,
        "collective_bytes_per_dev": coll["total_bytes"] * mb,
        "model_flops_per_dev": mf_per_dev,
        "useful_ratio": (mf_per_dev / flops) if flops else 0.0,
        "roofline_bound_s": max(terms.values()),
        "roofline_frac": (mf_per_dev / peak_flops) / max(terms.values())
        if max(terms.values()) > 0 else 0.0,
    }


def model_flops_for(cfg, shape) -> float:
    """Analytical MODEL_FLOPS for the whole step (all devices)."""
    n = cfg.n_active_params()
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    flops = mult * n * tokens
    if shape.kind == "decode":
        # attention KV reads dominate decode: 2*2*L*S*Hkv*D per token per layer
        attn_layers = len(cfg.attn_layers())
        hkv, hd = cfg.n_kv_heads, cfg.hd
        s_eff = min(shape.seq_len, cfg.sliding_window) if cfg.sliding_window \
            else shape.seq_len
        if cfg.mla is not None:
            hkv, hd = 1, cfg.mla.kv_lora_rank
        flops += shape.global_batch * attn_layers * 4 * s_eff * hkv * hd \
            * (cfg.n_heads // max(cfg.n_kv_heads, 1))
    return flops
