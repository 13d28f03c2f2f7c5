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
   series as counter tracks.

 * ``obs.profile`` — cold-vs-warm walls, kernel builds and per-entry-point
   dispatch counts, with ``analysis.contracts.REGISTRY`` as the source of
   truth for what the entry points are.

``python -m repro_torch.obs`` measures the telemetry tax on the fig12
capacity grid, pins chunked-vs-monolithic window series bitwise, reports
the tail percentiles, renders the ``phase_mix`` re-warming series and
writes ``BENCH_obs.json`` (``--device``, default the CUDA device).
"""
from repro_torch.obs.telemetry import WindowCollector, window_table
from repro_torch.obs.trace import (Tracer, chrome_trace, chrome_from_jsonl,
                                   telemetry_counter_events)
from repro_torch.obs import latency

__all__ = ["WindowCollector", "window_table", "Tracer", "chrome_trace",
           "chrome_from_jsonl", "telemetry_counter_events", "latency"]
