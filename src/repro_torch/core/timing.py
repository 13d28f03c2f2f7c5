"""DRAM timing + geometry constants (paper Table 1 / §4.2), PyTorch port.

Counterpart of ``repro.core.timing``.  All latencies are integer *ticks* of
1/8 ns so the simulator runs on exact int32 arithmetic.  A ``MechConfig``
splits into the shape-/branch-determining ``StaticConfig`` (plain Python,
hashable: one step function per distinct value) and ``MechParams``, the
numeric knobs as int32 tensors.  ``MechParams`` leaves are 0-d for one
config and ``(P,)`` for a stacked grid (``stack_params``), which is what
``dram.run_sweep`` batches over.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.obs import trace as obs_trace

TICKS_PER_NS = 8


def ns(x: float) -> int:
    return int(round(x * TICKS_PER_NS))


@dataclasses.dataclass(frozen=True)
class DRAMTimings:
    """DDR4-1600 (800 MHz bus) timings, ns — paper Table 1."""
    tCK: float = 1.25
    tRCD: float = 13.75
    tRP: float = 13.75
    tRAS: float = 35.0
    tCAS: float = 13.75
    tBL: float = 5.0          # 8-beat burst @ 1.6 GT/s
    tCCD: float = 6.25
    tRELOC: float = 1.0       # §4.2: 0.57 ns SPICE + 43 % guardband -> 1 ns
    # Fast-subarray reductions (LISA-VILLA SPICE model, §7)
    fast_tRCD_scale: float = 1.0 - 0.455
    fast_tRP_scale: float = 1.0 - 0.382
    fast_tRAS_scale: float = 1.0 - 0.629
    # LISA inter-subarray hop (row-buffer movement between adjacent subarrays)
    tLISA_HOP: float = 10.0

    # -- tick helpers ------------------------------------------------------
    @property
    def rcd(self): return ns(self.tRCD)
    @property
    def rp(self): return ns(self.tRP)
    @property
    def ras(self): return ns(self.tRAS)
    @property
    def cas(self): return ns(self.tCAS)
    @property
    def bl(self): return ns(self.tBL)
    @property
    def ccd(self): return ns(self.tCCD)
    @property
    def reloc(self): return ns(self.tRELOC)
    @property
    def rcd_fast(self): return ns(self.tRCD * self.fast_tRCD_scale)
    @property
    def rp_fast(self): return ns(self.tRP * self.fast_tRP_scale)
    @property
    def ras_fast(self): return ns(self.tRAS * self.fast_tRAS_scale)
    @property
    def lisa_hop(self): return ns(self.tLISA_HOP)

    def full_reloc_ns(self) -> float:
        """One isolated column relocation: ACT(src,tRAS) + RELOC + ACT(dst,
        counted as tRCD) + PRE (tRP).  Paper §4.2: 63.5 ns."""
        return self.tRAS + self.tRELOC + self.tRCD + self.tRP


DDR4 = DRAMTimings()


@dataclasses.dataclass(frozen=True)
class DRAMGeometry:
    """Per-channel geometry — paper Table 1 (4 GB/channel)."""
    n_banks: int = 16              # 4 bank groups x 4 banks
    n_rows: int = 32768            # per bank -> 16 * 32768 * 8 kB = 4 GB
    row_blocks: int = 128          # 8 kB row / 64 B cache block
    rows_per_subarray: int = 512   # -> 64 subarrays per bank
    n_cores: int = 8

    @property
    def n_subarrays(self) -> int:
        return self.n_rows // self.rows_per_subarray


GEOM = DRAMGeometry()


MECHANISMS = ("base", "lisa_villa", "figcache_slow", "figcache_fast",
              "figcache_ideal", "lldram")


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    """Memory-controller scheduling discipline (DESIGN.md §10): FCFS or
    FR-FCFS over a ``queue_depth`` transaction queue with a starvation
    cap, optionally behind write-drain batching.  ``core/sched/policies``
    realizes it as a host-side service-order permutation."""
    policy: str = "fcfs"
    queue_depth: int = 32
    starve_cap: int = 16
    arrival_window_ns: int = 50
    write_drain: bool = False
    drain_batch: int = 16

    def __post_init__(self):
        if self.policy not in ("fcfs", "frfcfs"):
            raise ValueError(f"unknown scheduling policy {self.policy!r}")
        if self.queue_depth < 1 or self.starve_cap < 0:
            raise ValueError("queue_depth must be >= 1, starve_cap >= 0")
        if self.arrival_window_ns < 0 or self.drain_batch < 1:
            raise ValueError("arrival_window_ns >= 0, drain_batch >= 1")

    @property
    def is_identity(self) -> bool:
        """True when scheduling cannot change the service order."""
        return self.policy == "fcfs" and not self.write_drain


SCHED_FCFS = SchedConfig()


# Padded FTS allocation buckets: SMALL_* covers every default §8 config,
# DEFAULT_* is the sweep-grid ceiling; larger configs round up to the next
# power of two (``_pad_bucket``).
SMALL_MAX_SLOTS = 512
SMALL_MAX_SEGS_PER_ROW = 8
DEFAULT_MAX_SLOTS = 1024
DEFAULT_MAX_SEGS_PER_ROW = 16


def _pad_bucket(n: int, floor: int) -> int:
    if n <= floor:
        return floor
    p = floor
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """The shape-/branch-determining half of a ``MechConfig``: mechanism,
    replacement policy and the padded FTS allocation.  Hashable; the
    grouping key of ``simulator.sweep``."""
    mechanism: str
    max_slots: int
    max_segs_per_row: int
    policy: str
    # route the tag compare + victim argmin through the fused
    # ``kernels/fts_lookup`` op (the CUDA kernel on a CUDA device)
    fts_kernel: bool = False
    # telemetry window period in REAL requests (DESIGN.md §15); 0 disables
    telemetry: int = 0

    @property
    def has_cache(self) -> bool:
        return self.mechanism in ("lisa_villa", "figcache_slow",
                                  "figcache_fast", "figcache_ideal")

    @property
    def fast_cache(self) -> bool:
        return self.mechanism in ("lisa_villa", "figcache_fast",
                                  "figcache_ideal")

    @property
    def free_reloc(self) -> bool:
        return self.mechanism == "figcache_ideal"


class MechParams(NamedTuple):
    """Numeric half of a ``MechConfig``: int32 tensors, 0-d for one config
    or ``(P,)`` for a stacked grid.  Includes the *effective* FTS geometry
    ``n_slots``/``segs_per_row``, which selects the live prefix of the
    padded arrays."""
    rcd: torch.Tensor
    rp: torch.Tensor
    cas: torch.Tensor
    bl: torch.Tensor
    ccd: torch.Tensor
    rcd_fast: torch.Tensor
    rp_fast: torch.Tensor
    reloc: torch.Tensor
    lisa_hop: torch.Tensor
    seg_blocks: torch.Tensor
    insert_threshold: torch.Tensor
    benefit_max: torch.Tensor
    n_slots: torch.Tensor
    segs_per_row: torch.Tensor
    slo_ns: torch.Tensor


def stack_params(points: Sequence[MechParams]) -> MechParams:
    """Stack 0-d ``MechParams`` into one ``(P,)`` batch."""
    return MechParams(*[torch.stack(xs) for xs in zip(*points)])


@dataclasses.dataclass(frozen=True)
class MechConfig:
    """One evaluated system configuration (paper §8)."""
    mechanism: str = "figcache_fast"
    seg_blocks: int = 16           # row segment = 16 blocks = 1/8 row
    cache_rows: int = 64           # rows in the in-DRAM cache region (per bank)
    policy: str = "row_benefit"    # row_benefit|segment_benefit|lru|random
    insert_threshold: int = 1      # consecutive misses before insertion
    benefit_bits: int = 5
    fts_kernel: bool = False       # fuse lookup+victim via kernels/fts_lookup
    telemetry: int = 0             # window period in real requests
    slo_ns: int = 0                # per-request latency SLO threshold (ns)
    sched: SchedConfig = SCHED_FCFS

    def __post_init__(self):
        if self.mechanism not in MECHANISMS:
            raise ValueError(f"unknown mechanism {self.mechanism!r}")

    @property
    def has_cache(self) -> bool:
        return self.mechanism in ("lisa_villa", "figcache_slow",
                                  "figcache_fast", "figcache_ideal")

    @property
    def fast_cache(self) -> bool:
        """Cache rows live in fast subarrays (reduced timings)?"""
        return self.mechanism in ("lisa_villa", "figcache_fast",
                                  "figcache_ideal")

    @property
    def segs_per_row(self) -> int:
        return GEOM.row_blocks // self.seg_blocks

    @property
    def n_slots(self) -> int:
        return self.cache_rows * self.segs_per_row

    @property
    def free_reloc(self) -> bool:
        return self.mechanism == "figcache_ideal"

    @property
    def static(self) -> StaticConfig:
        """Padded static structure for a config evaluated on its own: the
        tightest bucket rung covering it."""
        if not self.has_cache:
            return StaticConfig(self.mechanism, 1, 1, self.policy,
                                self.fts_kernel, self.telemetry)
        return StaticConfig(
            mechanism=self.mechanism,
            max_slots=_pad_bucket(self.n_slots, SMALL_MAX_SLOTS),
            max_segs_per_row=_pad_bucket(self.segs_per_row,
                                         SMALL_MAX_SEGS_PER_ROW),
            policy=self.policy,
            fts_kernel=self.fts_kernel,
            telemetry=self.telemetry,
        )

    @property
    def exact_static(self) -> StaticConfig:
        """Unpadded static structure (``max == actual``)."""
        return StaticConfig(
            mechanism=self.mechanism,
            max_slots=self.n_slots if self.has_cache else 1,
            max_segs_per_row=self.segs_per_row if self.has_cache else 1,
            policy=self.policy,
            fts_kernel=self.fts_kernel,
            telemetry=self.telemetry,
        )

    def params(self, t: DRAMTimings = DDR4, device=None) -> MechParams:
        """The numeric knobs as 0-d int32 tensors on ``device``, each one
        copy from the host (counted as ``h2d_copies`` / ``h2d_bytes``)."""
        dev = resolve_device(device)

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        p = MechParams(
            rcd=i32(t.rcd), rp=i32(t.rp), cas=i32(t.cas), bl=i32(t.bl),
            ccd=i32(t.ccd), rcd_fast=i32(t.rcd_fast), rp_fast=i32(t.rp_fast),
            reloc=i32(t.reloc), lisa_hop=i32(t.lisa_hop),
            seg_blocks=i32(self.seg_blocks),
            insert_threshold=i32(self.insert_threshold),
            benefit_max=i32((1 << self.benefit_bits) - 1),
            n_slots=i32(self.n_slots if self.has_cache else 1),
            segs_per_row=i32(self.segs_per_row if self.has_cache else 1),
            slo_ns=i32(self.slo_ns),
        )
        if obs_trace.recording():
            obs_trace.count(h2d_copies=len(p),
                            h2d_bytes=sum(x.nbytes for x in p))
        return p


def static_group_key(cfg: MechConfig):
    """The non-shape half of a static structure: configs sharing this key
    share one ``shared_static``."""
    return (cfg.mechanism, cfg.policy, cfg.fts_kernel, cfg.has_cache,
            cfg.telemetry)


def shared_static(cfgs) -> StaticConfig:
    """One static structure covering a whole config grid: the tightest
    bucket rung holding the grid's maximum ``n_slots`` / ``segs_per_row``."""
    cfgs = list(cfgs)
    key = static_group_key(cfgs[0])
    if any(static_group_key(c) != key for c in cfgs):
        raise ValueError("a shared static needs one mechanism/policy/"
                         "fts_kernel")
    c0 = cfgs[0]
    if not c0.has_cache:
        return StaticConfig(c0.mechanism, 1, 1, c0.policy, c0.fts_kernel,
                            c0.telemetry)
    return StaticConfig(
        mechanism=c0.mechanism,
        max_slots=_pad_bucket(max(c.n_slots for c in cfgs),
                              SMALL_MAX_SLOTS),
        max_segs_per_row=_pad_bucket(max(c.segs_per_row for c in cfgs),
                                     SMALL_MAX_SEGS_PER_ROW),
        policy=c0.policy,
        fts_kernel=c0.fts_kernel,
        telemetry=c0.telemetry,
    )


def paper_config(mechanism: str, **kw) -> MechConfig:
    """The exact §8 configurations."""
    if mechanism == "lisa_villa":
        # whole-row caching, 512 cache rows (16 fast subarrays x 32 rows)
        kw.setdefault("seg_blocks", GEOM.row_blocks)
        kw.setdefault("cache_rows", 512)
    return MechConfig(mechanism=mechanism, **kw)
