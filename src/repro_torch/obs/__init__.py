"""Flight-recorder observability (DESIGN.md §15), PyTorch port of
``repro.obs``:

 * ``obs.telemetry`` — host-side collection of the replay's telemetry
   window frames (``dram.resume_tel`` / ``sweep_resume_tel``, enabled via
   ``StaticConfig.telemetry``): ``WindowCollector`` masks the frames down
   to closed windows and serves per-window series (hit rates, relocation
   bursts, bus/MSHR stalls, per-bank issue mix, latency histograms);
 * ``obs.latency`` — the §16 histograms' percentiles with their bucket
   brackets, CDFs and exact SLO accounting (numpy);
 * ``obs.trace`` — a structured JSONL span/event log with a Chrome
   trace-event exporter (Perfetto / chrome://tracing), and the telemetry
   series as counter tracks; and ``obs.trace.PROGRAM``, the program
   recorder: spans (``span``) and counters (``count``) of the simulator's
   sweep path, stamped by ``time.time_ns()`` (the profiler's Unix-epoch
   clock), recorded in memory only while a torch profiler session is on,
   a bounded tail of 2**20 records.

 * ``obs.profile`` — cold-vs-warm walls, kernel builds and per-entry-point
   dispatch counts, with ``analysis.contracts.REGISTRY`` as the source of
   truth for what the entry points are.

``python -m repro_torch.obs`` measures the telemetry tax on the fig12
capacity grid, pins chunked-vs-monolithic window series bitwise, reports
the tail percentiles, renders the ``phase_mix`` re-warming series and
writes ``BENCH_obs.json`` (``--device``, default the CUDA device).
"""
from importlib import import_module

# names of the submodules, loaded at first use: ``core`` imports
# ``obs.trace`` for the program recorder, and ``obs.telemetry`` imports
# ``core.dram``, so an eager import here would be circular
_FROM = {"WindowCollector": "telemetry", "window_table": "telemetry",
         "Tracer": "trace", "chrome_trace": "trace",
         "chrome_from_jsonl": "trace", "telemetry_counter_events": "trace",
         "latency": None}

__all__ = list(_FROM)


def __getattr__(name):
    if name not in _FROM:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    if _FROM[name] is None:
        return import_module(f"{__name__}.{name}")
    return getattr(import_module(f"{__name__}.{_FROM[name]}"), name)
