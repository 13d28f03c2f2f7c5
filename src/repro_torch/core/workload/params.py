"""Workload parameterization: the static/tensor split for trace synthesis.
PyTorch port of ``repro.core.workload.params`` (DESIGN.md §11).

 * ``WorkloadSpec`` — the static half: scenario family (a branch of the
   generator), core count and trace shape (``n_channels`` x
   ``per_channel``), and the per-core knob tuple.  Hashable; one generator
   structure per distinct ``(family, n_cores, n_channels, per_channel)``.
 * ``WorkloadParams`` — the numeric half: every knob as a tensor leaf.  A
   spec packs one value per core (leaves ``(n_cores,)``, int32 / float32 as
   in the JAX package) and ``generators.generate_many`` stacks a further
   workload axis ``(W, n_cores)``.

``content_hash`` is the cache-key discipline for anything derived from a
workload description: a stable digest of the *contents* of specs,
dataclasses and tuples.  Class and field names enter the digest, so a port
spec hashes to the same hex digest as the JAX package's equal spec.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import traces
from repro_torch.core.timing import GEOM, TICKS_PER_NS
from repro_torch.device import resolve_device

# Scenario families (generators.py implements one branch per name):
#  * zipf_reuse    — the ported §7 application model (windowed bounded-Zipf
#                    popularity, hot row segments, MSHR-interleaved visits);
#  * stream        — sequential streaming sweep (high row locality, the
#                    pattern in-DRAM caching cannot help);
#  * stride        — strided/blocked sweep (fixed-distance reuse, partial
#                    row footprint);
#  * pointer_chase — dependent-load chain (low BLP, latency-bound);
#  * embed         — embedding-lookup / hash-join probe (high-skew iid
#                    random, one hot segment per row — matches ``figkv/``);
#  * phase_mix     — alternating zipf_reuse/stream phases.
FAMILIES = ("zipf_reuse", "stream", "stride", "pointer_chase", "embed",
            "phase_mix")

# Generator column granularity: 16 blocks per generator segment, matching
# the §3 observation unit of core/traces.py (hot_segs counts these).
SEG16 = 16
SPR = GEOM.row_blocks // SEG16      # generator segments per row (8)
MAX_CONTEXTS = 8                    # static ceiling of `contexts`


class WorkloadParams(NamedTuple):
    """Numeric half of a workload: one tensor leaf per knob.

    ``WorkloadSpec.params()`` stacks these per core (leaves ``(n_cores,)``);
    ``generators.generate_many`` adds a workload axis ``(W, n_cores)``.
    Unused knobs are inert for families that do not read them, so one
    shape serves every family and cross-family grids still stack.
    """
    n_pages: torch.Tensor       # i32 reuse working set, in DRAM rows
    zipf_a: torch.Tensor        # f32 popularity skew (zipf_reuse / embed)
    visit_mean: torch.Tensor    # f32 accesses per row visit
    hot_segs: torch.Tensor      # i32 hot generator-segments per page (1|2)
    rw: torch.Tensor            # f32 write fraction
    interarrival: torch.Tensor  # f32 mean burst gap, in ticks
    contexts: torch.Tensor      # i32 live miss streams (<= MAX_CONTEXTS)
    burst: torch.Tensor         # i32 back-to-back requests per episode
    window: torch.Tensor        # i32 active working-set window, in pages
    refresh: torch.Tensor       # f32 per-request window-turnover probability
    stream_frac: torch.Tensor   # f32 fraction of streaming (no-reuse) visits
    stride: torch.Tensor        # i32 row stride (stride family)
    touch_segs: torch.Tensor    # i32 segments touched per row visit
    phase_len: torch.Tensor     # i32 requests per phase (phase_mix)


@dataclasses.dataclass(frozen=True)
class CoreWorkload:
    """One core's workload knobs (the numeric content of a spec).

    A superset of ``traces.AppParams``: the shared fields carry the same
    meaning (``spec_from_apps`` copies them 1:1), the extras parameterize
    the synthetic families.  ``mpki`` feeds the IPC model only, never the
    trace itself.
    """
    name: str = "syn"
    mpki: float = 25.0
    n_pages: int = 2048
    zipf_a: float = 1.1
    visit_mean: float = 1.6
    hot_segs: int = 1
    rw: float = 0.25
    interarrival_ns: float = 30.0
    contexts: int = 4
    burst: int = 3
    window: int = 48
    refresh: float = 0.02
    stream_frac: float = 0.2
    stride: int = 17
    touch_segs: int = 1
    phase_len: int = 1024

    def __post_init__(self):
        if not 1 <= self.contexts <= MAX_CONTEXTS:
            raise ValueError(f"contexts must be in [1, {MAX_CONTEXTS}]: "
                             f"{self.contexts}")
        if self.burst < 1 or self.window < 1 or self.n_pages < 2:
            raise ValueError("burst and window must be >= 1 and n_pages "
                             f">= 2: {self}")
        if not 1 <= self.touch_segs <= SPR:
            raise ValueError(f"touch_segs must be in [1, {SPR}]: "
                             f"{self.touch_segs}")

    @classmethod
    def from_app(cls, app: traces.AppParams) -> "CoreWorkload":
        """Port one Table-2 application (the numpy oracle's knob tuple)."""
        return cls(name=app.name, mpki=app.mpki, n_pages=app.n_pages,
                   zipf_a=app.zipf_a, visit_mean=app.visit_mean,
                   hot_segs=app.hot_segs, rw=app.rw,
                   interarrival_ns=app.interarrival_ns,
                   contexts=app.contexts, burst=app.burst, window=app.window,
                   refresh=app.refresh, stream_frac=app.stream_frac)

    def app(self) -> traces.AppParams:
        """The ``AppParams`` view (what the IPC/energy model consumes)."""
        return traces.AppParams(
            name=self.name, mpki=self.mpki, n_pages=self.n_pages,
            zipf_a=self.zipf_a, visit_mean=self.visit_mean,
            hot_segs=self.hot_segs, rw=self.rw,
            interarrival_ns=self.interarrival_ns, contexts=self.contexts,
            burst=self.burst, window=self.window, refresh=self.refresh,
            stream_frac=self.stream_frac)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Static half of a workload: family branch + shape + per-core knobs.

    Hashable and tiny — the workload analogue of ``timing.StaticConfig``.
    Specs sharing ``static_key`` share one generator structure; their knob
    differences travel as tensors through ``params()``.
    """
    family: str
    cores: Tuple[CoreWorkload, ...]
    n_channels: int = 4
    per_channel: int = 4096
    seed: int = 0

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if not 1 <= len(self.cores) <= GEOM.n_cores:
            raise ValueError(f"1 to {GEOM.n_cores} cores, got "
                             f"{len(self.cores)}")
        if self.n_channels < 1 or self.per_channel < 1:
            raise ValueError("n_channels and per_channel must be >= 1")

    @property
    def n_cores(self) -> int:
        return len(self.cores)

    @property
    def static_key(self):
        """What determines the generator's structure (shapes + branch)."""
        return (self.family, self.n_cores, self.n_channels, self.per_channel)

    def params(self, device=None) -> WorkloadParams:
        """Stack the per-core knobs into ``(n_cores,)`` leaves on
        ``device`` (``None``: the CUDA device)."""
        dev = resolve_device(device)

        def leaf(vals, dtype):
            return torch.tensor(vals, dtype=dtype, device=dev)

        i32 = lambda f: leaf([int(getattr(c, f)) for c in self.cores],
                             torch.int32)
        f32 = lambda f: leaf([float(getattr(c, f)) for c in self.cores],
                             torch.float32)
        return WorkloadParams(
            n_pages=i32("n_pages"), zipf_a=f32("zipf_a"),
            visit_mean=f32("visit_mean"), hot_segs=i32("hot_segs"),
            rw=f32("rw"),
            # the product in float64, rounded once to float32
            interarrival=leaf([c.interarrival_ns * TICKS_PER_NS
                               for c in self.cores], torch.float32),
            contexts=i32("contexts"), burst=i32("burst"),
            window=i32("window"), refresh=f32("refresh"),
            stream_frac=f32("stream_frac"), stride=i32("stride"),
            touch_segs=i32("touch_segs"), phase_len=i32("phase_len"))

    def apps(self) -> Tuple[traces.AppParams, ...]:
        """Per-core ``AppParams`` for the IPC/energy model."""
        return tuple(c.app() for c in self.cores)

    def content_hash(self) -> str:
        return content_hash(self)


# Family presets: the knob tuples the scenario benchmarks use.  Synthetic
# names are not in ``traces.INTENSIVE``, so the IPC model applies the
# conservative MLP.
_PRESET_CORES = {
    "zipf_reuse": CoreWorkload(name="syn-zipf", mpki=25.0),
    "stream": CoreWorkload(name="syn-stream", mpki=40.0, touch_segs=SPR,
                           rw=0.3, interarrival_ns=12.0, burst=4,
                           n_pages=4096),
    "stride": CoreWorkload(name="syn-stride", mpki=25.0, stride=17,
                           touch_segs=2, rw=0.2, interarrival_ns=25.0,
                           n_pages=1024),
    "pointer_chase": CoreWorkload(name="syn-ptr", mpki=30.0, n_pages=8192,
                                  rw=0.05, interarrival_ns=90.0, burst=1,
                                  contexts=1),
    "embed": CoreWorkload(name="syn-embed", mpki=45.0, n_pages=4096,
                          zipf_a=1.2, rw=0.05, interarrival_ns=8.0,
                          burst=8, contexts=8),
    "phase_mix": CoreWorkload(name="syn-phase", mpki=30.0, touch_segs=SPR,
                              phase_len=1024, interarrival_ns=20.0),
}


def preset(family: str, n_cores: int = 8, n_channels: int = 4,
           per_channel: int = 4096, seed: int = 0, **overrides
           ) -> WorkloadSpec:
    """A ready-to-generate spec for one scenario family."""
    core = dataclasses.replace(_PRESET_CORES[family], **overrides)
    return WorkloadSpec(family=family, cores=(core,) * n_cores,
                        n_channels=n_channels, per_channel=per_channel,
                        seed=seed)


def spec_from_apps(apps, n_channels: int, per_channel: int,
                   seed: int = 0) -> WorkloadSpec:
    """Port a numpy-oracle workload (list of ``AppParams``, one per core)
    to the device zipf_reuse family — same knobs, device generation."""
    return WorkloadSpec(
        family="zipf_reuse",
        cores=tuple(CoreWorkload.from_app(a) for a in apps),
        n_channels=n_channels, per_channel=per_channel, seed=seed)


def _feed(h, obj) -> None:
    """Canonical recursive serialization for ``content_hash``."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        h.update(type(obj).__name__.encode())
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            _feed(h, getattr(obj, f.name))
    elif isinstance(obj, dict):
        h.update(b"{")
        for k in sorted(obj):
            _feed(h, k)
            _feed(h, obj[k])
        h.update(b"}")
    elif isinstance(obj, (tuple, list)):
        h.update(b"(")
        for x in obj:
            _feed(h, x)
        h.update(b")")
    else:
        h.update(repr(obj).encode())
        h.update(b";")


def content_hash(obj) -> str:
    """Stable digest of a workload description's *contents* (specs, app
    tuples, plain numbers...): equal content shares a cache entry,
    different content can never collide the way positional tuple keys
    can."""
    h = hashlib.sha1()
    _feed(h, obj)
    return h.hexdigest()
