"""Workloads as first-class, sweepable objects (DESIGN.md §11), PyTorch
port of ``repro.core.workload``.

A ``WorkloadSpec`` names a scenario family plus shape (static — one
generator structure each), its numeric knobs travel as tensors in
``WorkloadParams`` (per core and per workload), ``generators`` materializes
whole traces on the device (the CUDA device by default), and
``profile.characterize`` reduces any trace to the access-pattern stats the
paper's mechanisms are sensitive to.  The numpy generator in
``core/traces.py`` stays the statistical oracle the zipf_reuse family is
validated against.
"""
from repro_torch.core.workload.generators import (GEN_TRACE_LOG,
                                                  gen_trace_count, generate,
                                                  generate_many,
                                                  generate_stream)
from repro_torch.core.workload.params import (FAMILIES, MAX_CONTEXTS, SEG16,
                                              SPR, CoreWorkload,
                                              WorkloadParams, WorkloadSpec,
                                              content_hash, preset,
                                              spec_from_apps)
from repro_torch.core.workload.profile import characterize, summarize

__all__ = [
    "FAMILIES", "MAX_CONTEXTS", "SEG16", "SPR",
    "CoreWorkload", "WorkloadParams", "WorkloadSpec",
    "content_hash", "preset", "spec_from_apps",
    "GEN_TRACE_LOG", "gen_trace_count", "generate", "generate_many",
    "generate_stream",
    "characterize", "summarize",
]
