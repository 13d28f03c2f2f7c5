"""Aten-graph auditor: the port's counterpart of the JAX package's
``repro.analysis.jaxpr_audit``.

``make_fx(functionalize(fn), tracing_mode="fake")`` over fake tensors on the
``meta`` device gives the aten graph eager torch runs — no data, no device
time — so every check runs on the traced program, not on source text (the
AST lint's job).  Functionalization turns the step's in-place updates into
value nodes, so each carry leaf's new value is an ordinary graph node; and
on the ``meta`` device every tensor is off the host, so a ``.cpu()`` shows
up as a copy to the CPU.  Checks per entry (DESIGN.md §12):

* **x64 creep** (``x64-leak``) — any float64 value is an error, and so is
  any int64 value that feeds anything other than an index argument (the
  step's ``.long()`` indices, ``arange`` lanes and ``argmin`` positions
  narrowed back to int32 are allowed).  The port runs int32 like the JAX
  package; a wide dtype means a host value or a default dtype leaked in.
* **int32 overflow on carried accumulators** (``int32-overflow``,
  ``undeclared-accumulator``) — each int32 carry leaf must stay bounded for
  ``TRACE_LEN_BOUND`` steps.  The step's input leaf and output leaf pair up
  by name; structural analysis derives the per-step growth where it can
  (literal increments, bool->int casts, ``index_put`` read-modify-writes,
  saturating ``clamp`` / ``minimum``); ``CarryBound`` declarations (the JAX
  package's tables, copied) supply what it cannot.
* **host sync in a step** (``host-sync-in-step``, the counterpart of
  ``callback-in-scan``) — ``_local_scalar_dense`` (``.item()``),
  ``nonzero``, ``masked_select`` / boolean-mask indexing (data-dependent
  shapes) or a copy to the CPU.  A Python branch on a tensor fails the fake
  trace; the audit reports that as this finding instead of crashing.
* **oversized gather/scatter in a step** (``oversized-gather``) — an index,
  gather or scatter op touching more than ``GATHER_LIMIT`` elements per
  lane is the dense formulation leaking into a fused path.

Entries are declared by ``default_entries()``: each names an entry point,
how to trace it, and the carry-bound contract for its step.  ``audit_all()``
is the pass the CLI and CI run.
"""
from __future__ import annotations

import dataclasses
import math
import operator
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import findings as F

INT32_MAX = (1 << 31) - 1

# Declared capacity contract: the largest request stream one replay is
# promised to handle.  Carry bounds are checked against this, not against
# the representative trace used for the trace.
TRACE_LEN_BOUND = 1 << 20

# Declared simulated-time ceiling, ticks.  Workload generators emit arrival
# clocks < T_MAX and queue-drain times are bounded by it.
T_MAX = 1 << 30

# A per-step gather/scatter touching more elements per lane than this
# indicates the dense formulation leaked into a fused path.
GATHER_LIMIT = 1 << 17

CHECKS = {
    "x64-leak": "float64 value, or int64 value feeding anything but an "
                "index argument, in an audited program",
    "int32-overflow": "int32 carry leaf can exceed 2**31-1 within the "
                      "declared trace-length bound",
    "undeclared-accumulator": "int32 carry leaf with neither a derivable "
                              "step bound nor a CarryBound declaration",
    "host-sync-in-step": "host synchronisation (scalar read, data-dependent "
                         "shape, copy to the CPU) in an audited program",
    "oversized-gather": "per-step, per-lane index/gather/scatter above the "
                        "dense-fallback threshold",
}

# port rule -> the JAX package's rule it stands for
RENAMED = {"host-sync-in-step": "callback-in-scan"}

NOT_PORTED = {
    "weak-type-leak": "torch has no weak types: every tensor has a concrete "
                      "dtype, and Python scalars promote by the documented "
                      "type-promotion rules without re-promoting downstream",
    "while-in-scan": "an eager step has no traced loop primitive: a Python "
                     "loop over tensors either unrolls into the graph "
                     "(static trip count) or branches on a tensor, which is "
                     "a host-sync-in-step finding",
}


# ---------------------------------------------------------------------------
# carry-bound declarations (the JAX package's tables, same keys and numbers)

@dataclasses.dataclass(frozen=True)
class CarryBound:
    """Declared bound for one named carry leaf.

    ``abs_max``: externally-justified absolute bound (time-like and
    id-space leaves whose ceiling comes from the workload/geometry
    contract, not from per-step arithmetic).  ``step``: per-step growth
    bound used when structural derivation can't see one.  ``why`` is the
    written justification and is mandatory."""
    why: str
    abs_max: Optional[int] = None
    step: Optional[int] = None


_TIME = "bounded by the declared simulated-time ceiling T_MAX (workload "\
        "arrival clocks and queue-drain times stay under it by contract)"

# Bounds for the (BankState, Counters) carry of the simulator step, keyed
# by leaf name (NamedTuple field names).
SIM_CARRY_BOUNDS: Dict[str, CarryBound] = {
    "open_row":  CarryBound("row-id space: n_rows + cache rows < 2**20",
                            abs_max=1 << 20),
    "busy":      CarryBound(_TIME, abs_max=T_MAX),
    "mshr_ring": CarryBound(_TIME, abs_max=T_MAX),
    "bus_free":  CarryBound(_TIME, abs_max=T_MAX),
    "t_end":     CarryBound(_TIME, abs_max=T_MAX),
    "mshr_idx":  CarryBound("ring cursor mod N_MSHR", abs_max=8),
    "tags":      CarryBound("segment-id space < 2**26", abs_max=1 << 26),
    "miss_tags": CarryBound("segment-id space < 2**26", abs_max=1 << 26),
    "benefit":   CarryBound("saturates at MechParams.benefit_max < 2**10",
                            abs_max=1 << 10),
    "last_use":  CarryBound("step stamp <= TRACE_LEN_BOUND",
                            abs_max=TRACE_LEN_BOUND + 1),
    "row_sum":   CarryBound("sum of <= max_segs benefits, each < 2**10",
                            abs_max=1 << 21),
    "miss_cnt":  CarryBound("consecutive-miss run <= TRACE_LEN_BOUND",
                            abs_max=TRACE_LEN_BOUND + 1),
    "evict_row": CarryBound("row-id space", abs_max=1 << 20),
    "n_valid":   CarryBound("valid count <= max_slots", abs_max=1 << 12),
    "free_list": CarryBound("slot index < max_slots", abs_max=1 << 12),
    # per-request latency includes queueing delay, so its only sound step
    # bound is simulated time itself; the accumulator must therefore clamp
    # (dram.LAT_SUM_CAP) and the structural check verifies that it does.
    "lat_sum_ns": CarryBound("per-step growth bounded by simulated time",
                             step=T_MAX),
    "reloc_blocks": CarryBound("per-step growth <= seg_blocks ceiling 256",
                               step=256),
    "wb_blocks": CarryBound("per-step growth <= seg_blocks ceiling 256",
                            step=256),
}

# The orchestrator's ShardProgress adds two int32 progress accumulators to
# the simulator state (one add per segment):
#   seg_done  += 1 per segment           <= TRACE_LEN_BOUND segments
#   reqs_done += real requests in chunk  capped by the declared 2**27
#                                         stream-request ceiling.
ORCH_CARRY_BOUNDS: Dict[str, CarryBound] = {
    **SIM_CARRY_BOUNDS,
    "seg_done":  CarryBound("one increment per segment; segment count <= "
                            "TRACE_LEN_BOUND", abs_max=TRACE_LEN_BOUND),
    "reqs_done": CarryBound("real-request count across the shard's stream "
                            "< 2**27 by the sweep-plan contract",
                            abs_max=1 << 27),
}

# §16 latency-distribution planes of the telemetry carry: every histogram
# cell counts requests (one 0/1 add per step), so counts are bounded by
# TRACE_LEN_BOUND, never by simulated time; ring rows are copies.
HIST_CARRY_BOUNDS: Dict[str, CarryBound] = {
    "hist_win": CarryBound(
        "per-window bucket counts: one request per serial step (resets "
        "each window, so <= TRACE_LEN_BOUND even unwindowed)", step=1),
    "hist": CarryBound(
        "cumulative per-(rw, core, bucket) request counts: +1 element "
        "per real request, <= TRACE_LEN_BOUND", step=1),
    "slo": CarryBound(
        "cumulative per-core over-SLO request count <= TRACE_LEN_BOUND",
        step=1),
    "buf_hist": CarryBound(
        "ring rows are copies of per-window bucket counts "
        "<= TRACE_LEN_BOUND", abs_max=TRACE_LEN_BOUND + 1),
}

# Telemetry extension (``dram.TelScan`` leaves, DESIGN.md §15): the packed
# scalar lane reuses the lat_sum_ns saturation story — the vector clamps at
# dram.LAT_SUM_CAP and the pre-clamp add stays within LAT_SUM_CAP + T_MAX
# == INT32_MAX on every segment.
TEL_CARRY_BOUNDS: Dict[str, CarryBound] = {
    **SIM_CARRY_BOUNDS,
    **HIST_CARRY_BOUNDS,
    "scalars": CarryBound(
        "per-window deltas bounded by window period x max issue width "
        "(one request per serial step); time lanes grow by at most "
        "simulated time per step and the vector clamps at dram.LAT_SUM_CAP",
        step=T_MAX),
    "bank_issues": CarryBound(
        "one request issued per serial scan step (resets each window, so "
        "<= TRACE_LEN_BOUND even unwindowed)", step=1),
    "buf_scalars": CarryBound(
        "ring rows are copies of the clamped window vector "
        "<= dram.LAT_SUM_CAP", abs_max=(1 << 30) - 1),
    "buf_banks": CarryBound(
        "ring rows are copies of per-window bank issue counts "
        "<= TRACE_LEN_BOUND", abs_max=TRACE_LEN_BOUND + 1),
    "n": CarryBound(
        "closed-window count <= ring height W <= T + 2 <= "
        "TRACE_LEN_BOUND + 2", abs_max=TRACE_LEN_BOUND + 2),
}


# ---------------------------------------------------------------------------
# graph plumbing

def trace(fn, *args, functional: bool = True) -> torch.fx.GraphModule:
    """The aten graph of ``fn(*args)`` under fake tensors, functionalized
    unless ``functional=False`` (for programs with no carry to pair up,
    whose Python in-place operators such as ``&=`` functionalization
    refuses)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    if functional:
        fn = torch.func.functionalize(fn)
    return make_fx(fn, tracing_mode="fake")(*args)


def _op(node) -> str:
    """'add', 'index_put', ... for aten nodes; 'getitem'; '' otherwise."""
    if node.op != "call_function":
        return ""
    if node.target is operator.getitem:
        return "getitem"
    packet = getattr(node.target, "overloadpacket", None)
    return packet.__name__ if packet is not None else str(node.target)


def _val(node):
    v = node.meta.get("val") if isinstance(node, torch.fx.Node) else None
    return v if isinstance(v, torch.Tensor) else None


def _dtype(node):
    v = _val(node)
    return None if v is None else v.dtype


def _nodes_in(x):
    """Nodes in an fx argument (a node, or a list/tuple of them)."""
    if isinstance(x, torch.fx.Node):
        return [x]
    if isinstance(x, (list, tuple)):
        return [n for y in x for n in _nodes_in(y)]
    return []


_PASSTHROUGH = {"view", "_unsafe_view", "reshape", "unsqueeze", "squeeze",
                "expand", "t", "permute", "transpose", "select", "slice",
                "clone", "index", "gather", "contiguous", "alias", "repeat",
                "repeat_interleave", "lift_fresh_copy", "getitem", "unbind",
                "index_select", "flip", "narrow", "as_strided"}
_MERGE = {"maximum", "max", "cat", "stack"}
_SCATTER_SET = {"index_put", "scatter", "select_scatter", "slice_scatter",
                "index_copy"}
# where each scatter's written values sit among its arguments
_SCATTER_SRC = {"index_put": 2, "scatter": 3, "index_copy": 3,
                "select_scatter": 1, "slice_scatter": 1}


def _accumulates(node) -> bool:
    """An ``index_put`` with ``accumulate=True`` (``x[i] += v`` kept as one
    op)."""
    a = node.args
    return _op(node) == "index_put" and (
        (len(a) > 3 and bool(a[3])) or bool(node.kwargs.get("accumulate")))


# ---------------------------------------------------------------------------
# absolute-bound propagation (pure upper bounds, no carry relation)

def _abs_bound(v, depth: int = 0) -> Optional[int]:
    """Static upper bound for a non-negative integer value, or None."""
    if depth > 40:
        return None
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, (list, tuple)):
        bs = [_abs_bound(x, depth + 1) for x in v]
        return None if not bs or any(b is None for b in bs) else max(bs)
    if not isinstance(v, torch.fx.Node):
        return None
    if _dtype(v) == torch.bool:
        return 1
    op, a = _op(v), v.args

    def sub(x):
        return _abs_bound(x, depth + 1)

    if op in _PASSTHROUGH:
        return sub(a[0])
    if op == "_to_copy":
        return 1 if _dtype(a[0]) == torch.bool else sub(a[0])
    if op in ("zeros", "zeros_like", "new_zeros"):
        return 0
    if op in ("ones", "ones_like"):
        return 1
    if op in ("full", "full_like", "new_full"):
        return sub(a[-1])
    if op == "scalar_tensor":
        return sub(a[0])
    if op == "arange":
        end = sub(a[1] if len(a) > 1 and isinstance(a[1], int) else a[0])
        return None if end is None else max(end - 1, 0)
    if op == "add" and "alpha" not in v.kwargs:
        x, y = sub(a[0]), sub(a[1])
        return None if x is None or y is None else x + y
    if op == "mul":
        x, y = sub(a[0]), sub(a[1])
        return None if x is None or y is None else x * y
    if op in _MERGE:
        return sub(list(a[0]) if op in ("cat", "stack") else a[:2])
    if op in ("minimum", "min", "bitwise_and"):
        known = [b for b in (sub(x) for x in a[:2]) if b is not None]
        return min(known) if known else None
    if op in ("clamp", "clamp_max"):
        hi = a[2] if op == "clamp" and len(a) > 2 else \
            (a[1] if op == "clamp_max" else v.kwargs.get("max"))
        known = [b for b in (sub(a[0]), sub(hi)) if b is not None]
        return min(known) if known else None
    if op == "where":
        return sub(list(a[1:3]))
    if op == "remainder":
        d = sub(a[1])
        return None if d is None else d - 1
    if op == "div" and v.kwargs.get("rounding_mode") == "floor":
        return sub(a[0])
    if op in ("argmin", "argmax"):
        shape = _val(a[0]).shape
        dim = a[1] if len(a) > 1 else None
        n = math.prod(shape) if dim is None else shape[dim]
        return max(n - 1, 0)
    if op == "sum":
        x, out = _val(a[0]), _val(v)
        per = x.numel() // max(out.numel(), 1)
        b = sub(a[0])
        return None if b is None else b * per
    if op in _SCATTER_SET:
        x, y = sub(a[0]), sub(a[_SCATTER_SRC[op]])
        if x is None or y is None:
            return None
        return x + y if _accumulates(v) else max(x, y)
    return None


# ---------------------------------------------------------------------------
# relative bound: value <= max(carry_in + growth, floor)

@dataclasses.dataclass(frozen=True)
class _Rel:
    rel: bool                 # references the carry leaf?
    growth: Optional[int]     # per-step growth (None: unknown)
    floor: int                # absolute component


def _merge(rels) -> Optional[_Rel]:
    """Elementwise choice among values (select, max, scatter-set)."""
    if any(r is None for r in rels):
        return None
    rel = any(r.rel for r in rels)
    growths = [r.growth for r in rels if r.rel]
    g = None if any(x is None for x in growths) else \
        (max(growths) if growths else 0)
    return _Rel(rel, g if rel else 0, max(r.floor for r in rels))


def _add(ra: Optional[_Rel], rb: Optional[_Rel]) -> Optional[_Rel]:
    if ra is None or rb is None or (ra.rel and rb.rel):
        return None                           # carry + carry: out of scope
    if rb.rel:
        ra, rb = rb, ra
    if not ra.rel:
        return _Rel(False, 0, ra.floor + rb.floor)
    g = None if ra.growth is None else ra.growth + rb.floor
    return _Rel(True, g, ra.floor + rb.floor)


def _rel_bound(v, carry_in, depth: int = 0) -> Optional[_Rel]:
    if depth > 40:
        return None
    if v is carry_in:
        return _Rel(True, 0, 0)
    if not isinstance(v, torch.fx.Node) or v.op != "call_function":
        b = _abs_bound(v)
        return None if b is None else _Rel(False, 0, b)
    op, a = _op(v), v.args

    def sub(x):
        return _rel_bound(x, carry_in, depth + 1)

    if op in _PASSTHROUGH:
        return sub(a[0])
    if op == "_to_copy":
        return _Rel(False, 0, 1) if _dtype(a[0]) == torch.bool else sub(a[0])
    if op == "add" and "alpha" not in v.kwargs:
        return _add(sub(a[0]), sub(a[1]))
    if op == "scatter_add":
        return _add(sub(a[0]), sub(a[3]))
    if op in _SCATTER_SET:
        parts = [sub(a[0]), sub(a[_SCATTER_SRC[op]])]
        return _add(*parts) if _accumulates(v) else _merge(parts)
    if op in ("clamp", "clamp_max", "minimum", "min"):
        # saturating clamp: min(chain, K) caps the whole chain at K
        if op == "clamp":
            caps = [a[2] if len(a) > 2 else v.kwargs.get("max")]
        elif op == "clamp_max":
            caps = [a[1]]
        else:
            caps = list(a[:2])
        known = [b for b in (_abs_bound(c) for c in caps if c is not None)
                 if b is not None]
        if known:
            return _Rel(False, 0, min(known))
        return sub(a[0]) if op in ("clamp", "clamp_max") else None
    if op in _MERGE:
        return _merge([sub(x) for x in
                       (a[0] if op in ("cat", "stack") else a[:2])])
    if op == "where":
        return _merge([sub(a[1]), sub(a[2])])
    b = _abs_bound(v)
    return None if b is None else _Rel(False, 0, b)


# ---------------------------------------------------------------------------
# per-entry audit

@dataclasses.dataclass(frozen=True)
class Entry:
    """One audited entry: how to trace it and its carry contract.

    ``trace()`` returns the graph; its first ``len(carry_names)``
    placeholders are the carry leaves going in and its first as many
    outputs the same leaves coming out.  ``step`` marks a per-request step
    (the per-lane gather limit applies over ``lanes`` lanes); ``allow``
    maps a rule this entry may break to the reason it may."""
    name: str
    trace: Callable[[], torch.fx.GraphModule]
    carry_names: Tuple[str, ...] = ()
    carry_bounds: Dict[str, CarryBound] = dataclasses.field(
        default_factory=dict)
    len_bound: int = TRACE_LEN_BOUND
    lanes: int = 1
    step: bool = False
    allow: Dict[str, str] = dataclasses.field(default_factory=dict)


_INDEX_ARG = {"index": 1, "index_put": 1, "gather": 2, "scatter": 2,
              "scatter_add": 2, "index_select": 2, "index_add": 2,
              "index_copy": 2, "take": 1}
_VIEWS = {"view", "_unsafe_view", "reshape", "unsqueeze", "squeeze",
          "expand", "t", "permute", "transpose", "select", "slice",
          "clone", "contiguous", "alias", "repeat", "getitem", "unbind",
          "lift_fresh_copy", "clamp", "clamp_min", "clamp_max"}


# ops that read only their input's shape, dtype aside
_SHAPE_ONLY = {"ones_like", "zeros_like", "empty_like", "full_like",
               "new_zeros", "new_ones", "new_full", "new_empty", "sym_size"}


def _int64_is_index(node, seen=None) -> bool:
    """True if every use of an int64 value is an index argument, a view of
    one that is, or a narrowing cast back to int32."""
    seen = set() if seen is None else seen
    if node in seen:
        return True
    seen.add(node)
    for user in node.users:
        op = _op(user)
        pos = _INDEX_ARG.get(op)
        if pos is not None and len(user.args) > pos \
                and node in _nodes_in(user.args[pos]) \
                and node not in _nodes_in(user.args[:pos]) \
                and node not in _nodes_in(user.args[pos + 1:]):
            continue
        if op == "_to_copy" and _dtype(user) == torch.int32:
            continue
        if op in _SHAPE_ONLY:
            continue
        if op in _VIEWS and user.args and user.args[0] is node:
            if _int64_is_index(user, seen):
                continue
        return False
    return True


def _audit_dtypes(gm, entry: str) -> List[F.Finding]:
    out, seen = [], set()
    for node in gm.graph.nodes:
        dt = _dtype(node)
        if node.op not in ("call_function", "placeholder") or dt is None:
            continue
        op = _op(node) or node.op
        if dt in (torch.float64, torch.complex128) and (op, dt) not in seen:
            seen.add((op, dt))
            out.append(F.Finding(
                rule="x64-leak", entry=entry,
                message=f"{dt} value produced by `{op}` ({node.name}); the "
                        f"port computes in 32 bits — a host float or a "
                        f"default dtype leaked into the program"))
        elif dt in (torch.int64, torch.uint64) \
                and not _int64_is_index(node) and (op, dt) not in seen:
            seen.add((op, dt))
            out.append(F.Finding(
                rule="x64-leak", entry=entry,
                message=f"{dt} value from `{op}` ({node.name}) feeds "
                        f"`{_op(next(iter(node.users)))}`, not only index "
                        f"arguments; compute in int32 and widen at the "
                        f"index (`.long()`)"))
    return out


_SYNC_OPS = {"_local_scalar_dense", "nonzero", "masked_select", "item",
             "unique", "_unique2", "unique_consecutive", "nonzero_static"}
_GATHERS = {"index", "index_put", "gather", "scatter", "scatter_add",
            "index_select", "index_add", "index_copy", "take"}


def _audit_hygiene(gm, entry: Entry) -> List[F.Finding]:
    out = []
    for node in gm.graph.nodes:
        op = _op(node)
        if not op:
            continue
        why = None
        if op in _SYNC_OPS:
            why = f"`{op}` reads a device value on the host"
        elif op == "index" and any(_dtype(i) == torch.bool
                                   for i in _nodes_in(node.args[1])):
            why = "boolean-mask indexing has a data-dependent shape"
        elif op in ("_to_copy", "copy_"):
            src, dst = _val(node.args[0] if op == "_to_copy"
                            else node.args[1]), _val(node)
            if src is not None and dst is not None \
                    and dst.device.type == "cpu" \
                    and src.device.type != "cpu":
                why = f"`{op}` copies a {src.device.type} tensor to the CPU"
        if why:
            out.append(F.Finding(
                rule="host-sync-in-step", entry=entry.name,
                message=f"{why} ({node.name}): the host waits for the "
                        f"device every call; keep the value on the device"))
        elif entry.step and op in _GATHERS:
            sizes = [x.numel() for x in
                     [_val(node)] + [_val(n) for n in _nodes_in(node.args)]
                     if x is not None]
            per_lane = max(sizes or [0]) // max(entry.lanes, 1)
            if per_lane > GATHER_LIMIT:
                out.append(F.Finding(
                    rule="oversized-gather", entry=entry.name,
                    message=f"`{op}` ({node.name}) touches {per_lane} "
                            f"elements per lane per step (> {GATHER_LIMIT});"
                            f" the dense formulation is leaking into a "
                            f"fused path"))
    return out


def _audit_carries(gm, entry: Entry) -> List[F.Finding]:
    out = []
    ph = [n for n in gm.graph.nodes if n.op == "placeholder"]
    outs = next(n for n in gm.graph.nodes if n.op == "output").args[0]
    for i, name in enumerate(entry.carry_names):
        in_v, out_v = ph[i], outs[i]
        if _dtype(in_v) != torch.int32 or out_v is in_v:
            continue                      # not int32, or passed through
        decl = entry.carry_bounds.get(name)
        if decl is not None and decl.abs_max is not None:
            if decl.abs_max + (decl.step or 0) > INT32_MAX:
                out.append(F.Finding(
                    rule="int32-overflow", entry=entry.name,
                    message=f"carry `{name}` declared abs bound "
                            f"{decl.abs_max} does not fit int32"))
            continue
        rel = _rel_bound(out_v, in_v)
        if rel is None:
            if decl is not None and decl.step is not None:
                # structure opaque but a per-step growth is declared:
                # worst-case accumulate from a zero base
                rel = _Rel(True, decl.step, 0)
            else:
                out.append(F.Finding(
                    rule="undeclared-accumulator", entry=entry.name,
                    message=f"carry `{name}` ({out_v.name}): cannot derive "
                            f"a step bound and no CarryBound is declared; "
                            f"declare one in graph_audit (with a why) or "
                            f"restructure the update"))
                continue
        if not rel.rel:
            # clamped/replaced: bound is the floor, plus one declared step
            # of pre-clamp headroom for the internal add
            slack = (decl.step if decl is not None else 0) or 0
            if rel.floor + slack > INT32_MAX:
                out.append(F.Finding(
                    rule="int32-overflow", entry=entry.name,
                    message=f"carry `{name}` clamps at {rel.floor} but "
                            f"pre-clamp growth {slack} can wrap int32; "
                            f"lower the clamp"))
            continue
        growth = rel.growth
        if growth is None and decl is not None:
            growth = decl.step
        if growth is None:
            out.append(F.Finding(
                rule="undeclared-accumulator", entry=entry.name,
                message=f"carry `{name}` ({out_v.name}) accumulates with an "
                        f"underivable per-step increment; declare a "
                        f"CarryBound(step=...) with a justification"))
            continue
        total = rel.floor + entry.len_bound * growth
        if total > INT32_MAX:
            out.append(F.Finding(
                rule="int32-overflow", entry=entry.name,
                message=f"carry `{name}` can reach ~{total:.3g} after "
                        f"{entry.len_bound} steps (step bound {growth}) and "
                        f"wraps int32; clamp the accumulator (saturating "
                        f"min) or widen the contract"))
    return out


def _data_dependent(e: Exception) -> bool:
    text = f"{type(e).__name__}: {e}"
    return any(s in text for s in (
        "DataDependent", "data-dependent", "unallocated storage",
        "meta tensors", "item()", "is_nonzero", "Boolean value of Tensor"))


def audit_entry(entry: Entry) -> List[F.Finding]:
    # tracing runs the replay and generator code paths, which log replays
    # and generator builds; restore the logs so the audit never skews the
    # counts the contract pass (and tests) measure.
    from repro_torch.core import dram, workload
    marks = (dram.REPLAYS.mark(), len(workload.GEN_TRACE_LOG))
    try:
        gm = entry.trace()
    except Exception as e:    # noqa: BLE001 - a broken entry IS a finding
        rule = "host-sync-in-step" if _data_dependent(e) else "x64-leak"
        return [F.Finding(
            rule=rule, entry=entry.name,
            message=f"entry failed to trace: {type(e).__name__}: "
                    f"{str(e).splitlines()[0] if str(e) else ''}")]
    finally:
        dram.REPLAYS.restore(marks[0])
        del workload.GEN_TRACE_LOG[marks[1]:]
    out = _audit_dtypes(gm, entry.name) + _audit_hygiene(gm, entry)
    if entry.carry_names:
        out += _audit_carries(gm, entry)
    return [f for f in out if f.rule not in entry.allow]


# ---------------------------------------------------------------------------
# entry declarations for the port

META = torch.device("meta")


def _leaves(tree, prefix=""):
    """(name, tensor) for every tensor leaf of nested NamedTuples, named
    by the innermost field; ``None`` subtrees are skipped."""
    out = []
    if tree is None:
        return out
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    fields = getattr(tree, "_fields", None)
    for i, x in enumerate(tree):
        out += _leaves(x, fields[i] if fields else prefix)
    return out


def _rebuild(tree, it):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return next(it)
    vals = [_rebuild(x, it) for x in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


def carry_leaf_names(carry) -> Tuple[str, ...]:
    return tuple(name for name, _ in _leaves(carry))


def _trace_carried(fn, carry, *rest):
    """Trace ``fn(carry, *rest) -> new carry (same structure)`` with the
    carry leaves first among the graph's inputs and outputs."""
    trees = (carry,) + rest
    flat = [x for t in trees for _, x in _leaves(t)]

    def flat_fn(*args):
        it = iter(args)
        built = [_rebuild(t, it) for t in trees]
        return tuple(x for _, x in _leaves(fn(*built)))

    return trace(flat_fn, *flat)


def _toy_trace_np(T: int, channels: int = 0):
    shp = (T,) if channels == 0 else (channels, T)
    from repro_torch.core.dram import Trace
    return Trace(*[np.zeros(shp, dtype=bool if f == "is_write" else np.int32)
                   for f in Trace._fields])


def _step_setup(cfg, channels: int, batch: int, T: int = 256):
    """(lane trace, lane params, SimState) on the meta device for ``batch``
    params points x ``channels`` channels."""
    from repro_torch.core import dram
    from repro_torch.core.timing import stack_params
    params = cfg.params(device=META)
    if batch:
        params = stack_params([params] * batch)
    st = dram.sim_init(cfg.static, channels=channels or None,
                       batch=batch or None, device=META)
    return dram._prepare(_toy_trace_np(T, channels), params, st, META)


def _fast_cfg(**kw):
    from repro_torch.core.timing import paper_config
    return paper_config("figcache_fast", **kw)


def _trace_step(variant: str = "fused", channels: int = 0, batch: int = 0,
                period: int = 0):
    """Trace one request of ``dram.make_step(static, variant)`` over the
    lanes of ``batch`` params points x ``channels`` channels; with
    ``period`` the telemetry step, its ``TelScan`` in the carry."""
    from repro_torch.core import dram
    cfg = _fast_cfg(telemetry=period)
    tr, lp, st = _step_setup(cfg, channels, batch)
    step = dram.make_step(cfg.static, variant=variant)
    tel = dram._open(cfg.static, st, tr.t_issue.shape[0])
    req = dram.Trace(*(f[0] for f in tr))
    return _trace_carried(lambda c, p, r: step(p, c, r),
                          (st.bank, st.cnt, tel), lp, req)


def _step_names(period: int = 0) -> Tuple[str, ...]:
    from repro_torch.core import dram
    cfg = _fast_cfg(telemetry=period)
    st = dram.sim_init(cfg.static, device=META)
    return carry_leaf_names((st.bank, st.cnt,
                             dram._open(cfg.static, st, 256)))


def _shard_setup(channels: int = 2, batch: int = 4):
    from repro_torch.core.timing import stack_params
    from repro_torch.launch import orchestrator
    cfg = _fast_cfg()
    prog = orchestrator.init_progress(cfg.static, batch, channels,
                                      device=META)
    params = stack_params([cfg.params(device=META)] * batch)
    return cfg.static, prog, params


def _trace_shard_step():
    """Trace ``orchestrator.shard_step`` over a one-request, two-channel
    segment of a batch of 4: one eager step of the replay plus the two
    progress accumulators, the ``ShardProgress`` carry in and out."""
    from repro_torch.core import dram
    from repro_torch.launch import orchestrator
    static, prog, params = _shard_setup()
    seg = dram.Trace(*[torch.as_tensor(x).to(META)
                       for x in _toy_trace_np(1, channels=2)])
    return _trace_carried(
        lambda pr, s, p: orchestrator.shard_step(s, static, p, pr,
                                                 device=META),
        prog, seg, params)


def _shard_names() -> Tuple[str, ...]:
    return carry_leaf_names(_shard_setup()[1])


def _trace_generate():
    """Trace the generator ``workload.generate`` builds for one
    representative static structure (zipf_reuse, 2 cores x 1 channel x
    1024 requests).  On CPU fake tensors: its constant tables are
    ``torch.tensor`` literals, which the meta device cannot lift."""
    from repro_torch.core.timing import GEOM
    from repro_torch.core.workload import WorkloadParams, preset
    from repro_torch.core.workload.generators import _make_gen
    spec = preset("zipf_reuse", n_cores=2, n_channels=1, per_channel=1024)
    gen = _make_gen(spec.family, spec.n_cores, spec.n_channels,
                    spec.per_channel, GEOM)
    params = WorkloadParams(*[x[None] for x in spec.params("cpu")])
    return _trace_carried(lambda p: gen(p, [spec.seed]), params)


def _trace_kernel(which: str):
    """Trace a kernel's plain version on meta tensors at a small shape."""
    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=META)

    f32 = torch.float32
    if which == "fts_lookup":
        from repro_torch.kernels.fts_lookup.ref import fts_lookup_ref
        return trace(fts_lookup_ref, z(4, 16, 512), z(4, 16, 512), z(4),
                     z(4), z(4))
    if which == "reloc":
        from repro_torch.kernels.figaro_reloc.ref import reloc_ref
        return trace(reloc_ref, z(2, 64, 128, dtype=f32),
                     z(2, 32, 128, dtype=f32), z(2, 8), z(2, 8))
    if which == "decode":
        from repro_torch.kernels.figcache_decode.ref import \
            figcache_decode_ref
        return trace(figcache_decode_ref, z(2, 4, 64, dtype=f32),
                     z(2, 128, 4, 64, dtype=f32), z(2, 128, 4, 64, dtype=f32),
                     z(2, 128, dtype=torch.bool))
    if which == "mha":
        from repro_torch.kernels.flash_attention.ref import \
            flash_attention_ref
        return trace(lambda q, k, v: flash_attention_ref(q, k, v),
                     z(2, 256, 4, 64, dtype=f32),
                     z(2, 256, 4, 64, dtype=f32), z(2, 256, 4, 64, dtype=f32),
                     functional=False)
    if which == "figkv_tx":
        from repro_torch.configs import FIGKVConfig
        from repro_torch.core import fts as fts_lib
        from repro_torch.kernels.figkv_tx.ref import figkv_tx_ref
        fig = FIGKVConfig()
        B, slots, n_segs, E = 2, fig.fast_rows * fig.segs_per_row, 64, 256
        fts = fts_lib.init_lanes(B, slots, fig.segs_per_row, device=META)

        def tx(f, sel, pk, pv, fk, fv):
            figkv_tx_ref(sel, 7, n_segs, f, pk, pv, fk, fv, fig)
            return f
        return _trace_carried(tx, fts, z(B, 8), z(B, n_segs, E, dtype=f32),
                              z(B, n_segs, E, dtype=f32),
                              z(B, slots, E, dtype=f32),
                              z(B, slots, E, dtype=f32))
    raise ValueError(which)


_GEN_X64 = ("the generator emulates XLA's uint32 threefry words in int64 "
            "masked to 32 bits and XLA's f32 transcendentals with exact "
            "float64 fma emulation (core/workload/rng.py, xla_math.py): "
            "the wide values are what makes its traces bitwise the JAX "
            "package's")


def default_entries() -> List[Entry]:
    names, tel_names = _step_names(), _step_names(period=64)
    sim = dict(carry_names=names, carry_bounds=SIM_CARRY_BOUNDS, step=True)
    return [
        Entry("dram.step[fused]", lambda: _trace_step(), lanes=1, **sim),
        Entry("dram.step[fused, 2 channels]",
              lambda: _trace_step(channels=2), lanes=2, **sim),
        Entry("dram.step[fused, 4 params x 2 channels]",
              lambda: _trace_step(channels=2, batch=4), lanes=8, **sim),
        Entry("dram.step[dense]", lambda: _trace_step("dense"), lanes=1,
              **sim),
        Entry("dram.step[telemetry, 4 params x 2 channels]",
              lambda: _trace_step(channels=2, batch=4, period=64), lanes=8,
              carry_names=tel_names, carry_bounds=TEL_CARRY_BOUNDS,
              step=True),
        Entry("orchestrator.shard_step[sharded]", _trace_shard_step,
              carry_names=_shard_names(), carry_bounds=ORCH_CARRY_BOUNDS,
              lanes=8, step=True),
        Entry("workload.generate[zipf_reuse, 1024]", _trace_generate,
              allow={"x64-leak": _GEN_X64}),
        Entry("kernels.fts_lookup_ref", lambda: _trace_kernel("fts_lookup")),
        Entry("kernels.reloc_ref", lambda: _trace_kernel("reloc")),
        Entry("kernels.figcache_decode_ref", lambda: _trace_kernel("decode")),
        Entry("kernels.flash_attention_ref", lambda: _trace_kernel("mha")),
        Entry("kernels.figkv_tx_ref", lambda: _trace_kernel("figkv_tx")),
    ]


def audit_all(entries: Optional[List[Entry]] = None) -> F.Report:
    rep = F.Report(passes=["graph-audit"])
    for entry in (entries if entries is not None else default_entries()):
        rep.scanned.append(entry.name)
        rep.extend(audit_entry(entry))
    return rep
