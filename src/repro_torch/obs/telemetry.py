"""Host-side collection of the replay's telemetry windows (DESIGN.md §15),
PyTorch port of ``repro.obs.telemetry``.

The telemetry segments (``dram.resume_tel`` / ``sweep_resume_tel``)
return the segment's CLOSED windows as a fixed-shape
``dram.TelemetryFrame`` (``W = min(T, T // period + 2) + 1`` rows per
segment, trailing rows ``valid=False`` filler).  ``WindowCollector``
absorbs each segment's frames (``add``), takes the final partial window
and the cumulative §16 planes off the carried ``SimState.tel`` cursor
(``close``), and serves masked, concatenated per-window series.  Because
windows are indexed by the real-request count, a collector fed chunked
segments produces the same series, byte for byte, as one fed the
monolithic replay's frames (``tests/test_torch_obs.py``).

Frames stay as handed over (device tensors) until ``series()``: collecting
them never synchronises the device, so the streaming drivers' launches
stay asynchronous.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dram
from repro_torch.obs import latency

__all__ = ["WindowCollector", "window_table", "series_csv"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _cat(xs) -> np.ndarray:
    """Concatenate one field's rows of every segment along the window
    axis and bring them to the host in one copy."""
    if all(isinstance(x, torch.Tensor) for x in xs):
        return _host(torch.cat(xs))
    return np.concatenate([_host(x) for x in xs])


class WindowCollector:
    """Accumulate telemetry frames from a (possibly chunked) replay.

    Use with the streaming drivers::

        col = WindowCollector()
        streaming.simulate_stream(segments, cfg, telemetry=col)
        s = col.series()          # {"win_idx": ..., "w_cache_hits": ...,
                                  #  "hit_rate": ..., ...}

    or feed ``dram.resume_tel`` outputs directly (``add`` per segment,
    ``close(state)`` once at the end).  For batched/multi-channel runs the
    frames carry lead axes (P, [C,]); pass the lead index to ``series`` to
    select one stream, e.g. ``series(index=(p, c))``.  The final state is
    in the port's lane layout (N, ...); ``close`` lays its cursor out
    along the frames' lead axes.
    """

    _fields = dram.TelemetryWindows._fields

    def __init__(self) -> None:
        self._chunks: List[dram.TelemetryFrame] = []
        self._final: Optional[dram.TelemetryState] = None
        self._closed = False

    def add(self, frames: dram.TelemetryFrame) -> None:
        """Absorb one segment's frames (any lead axes, window axis last
        but for the planes' own)."""
        if self._closed:
            raise ValueError("collector already closed")
        self._chunks.append(frames)

    def close(self, state: dram.SimState) -> None:
        """Take the final (possibly partial) window and the cumulative
        §16 planes from the replay's carry."""
        if self._closed:
            raise ValueError("collector already closed")
        tel = state.tel
        if tel is not None:
            if self._chunks:
                lead = tuple(self._chunks[0].valid.shape[:-1])
            else:
                lanes = int(tel.hist.shape[0])
                lead = () if lanes == 1 else (lanes,)
            tel = dram._unlane(tel, lead)
        self._final = tel
        self._closed = True

    def block(self) -> None:
        """Wait for every collected frame (timing fences): synchronises
        the device the frames live on."""
        for x in (self._chunks[-1].valid if self._chunks else None,
                  self._final.hist if self._final is not None else None):
            if isinstance(x, torch.Tensor) and x.is_cuda:
                torch.cuda.synchronize(x.device)

    @property
    def n_segments(self) -> int:
        return len(self._chunks)

    def series(self, index: Tuple[int, ...] = ()) -> Dict[str, np.ndarray]:
        """Per-window series for ONE stream, oldest window first.

        ``index`` selects the lead (params/channel) axes; what remains
        must be the window axis.  Returns every ``TelemetryWindows`` field
        as a 1-D int64 array over windows (``w_bank_issues`` is
        ``(n_windows, n_banks)``, ``w_hist`` ``(n_windows,
        HIST_BUCKETS)``) plus the derived float rates ``hit_rate`` /
        ``row_hit_rate`` / ``write_frac`` / ``avg_lat_ns`` / ``slo_rate``
        and the per-window tail estimates ``p50_ns`` / ``p99_ns``.
        The final partial window is included iff it saw any requests.

        Zero-request windows are guarded explicitly: count rates emit
        0.0 and the latency-valued series (``avg_lat_ns``, percentiles)
        emit NaN — never a division artifact or a runtime warning.
        """
        cols: Dict[str, List[np.ndarray]] = {f: [] for f in self._fields}
        if self._chunks:
            v = _cat([fr.valid[index] for fr in self._chunks])
            if v.ndim != 1:
                raise ValueError("index must select all lead axes; got "
                                 f"shape {v.shape}")
            m = v.astype(bool)
            for f in self._fields:
                cols[f].append(_cat([getattr(fr.win, f)[index]
                                     for fr in self._chunks])[m])
        if self._final is not None and \
                int(_host(self._final.win.w_reqs)[index]) > 0:
            for f in self._fields:
                cols[f].append(
                    _host(getattr(self._final.win, f))[index][None])
        empty = {"w_bank_issues": dram.GEOM.n_banks,
                 "w_hist": dram.HIST_BUCKETS}
        out = {f: (np.concatenate(cols[f]).astype(np.int64) if cols[f]
                   else np.zeros((0,) + ((empty[f],) if f in empty else ()),
                                 np.int64)) for f in self._fields}
        if not np.all(np.diff(out["win_idx"]) > 0):
            raise ValueError("window ordinals must be strictly increasing")
        nz = out["w_reqs"] > 0
        reqs = np.where(nz, out["w_reqs"], 1).astype(np.float64)

        def rate(num):
            return np.where(nz, num / reqs, 0.0)

        out["hit_rate"] = rate(out["w_cache_hits"])
        out["row_hit_rate"] = rate(out["w_row_hits"])
        out["write_frac"] = rate(out["w_writes"])
        out["slo_rate"] = rate(out["w_slo"])
        out["avg_lat_ns"] = np.where(nz, out["w_lat_ns"] / reqs, np.nan)
        out.update(latency.tail_series(out, qs=(0.5, 0.99)))
        return out

    def cumulative(self, index: Tuple[int, ...] = ()) -> Dict[str, np.ndarray]:
        """The run-cumulative §16 planes of one stream (``close`` first).

        ``hist`` is the ``(2, n_cores, HIST_BUCKETS)`` read/write bucket
        counts, ``slo`` the per-core over-SLO request counts — feed them
        to ``obs.latency`` (``percentiles``, ``core_tails``, ``cdf``)."""
        if not self._closed or self._final is None:
            raise ValueError("cumulative planes live on the final carry; "
                             "close() first")
        return {"hist": _host(self._final.hist)[index].astype(np.int64),
                "slo": _host(self._final.slo)[index].astype(np.int64)}


def window_table(series: Dict[str, np.ndarray], max_rows: int = 24) -> str:
    """Render a compact fixed-width per-window table.

    Long series are subsampled evenly to ``max_rows`` so the table stays
    terminal-sized; the window ordinal column keeps the timeline honest.
    """
    n = len(series["win_idx"])
    if n == 0:
        return "(no closed telemetry windows)"
    rows = np.arange(n) if n <= max_rows else np.unique(
        np.linspace(0, n - 1, max_rows).astype(int))
    head = f"{'win':>6} {'reqs':>6} {'hit%':>6} {'rowhit%':>8} " \
           f"{'ins':>5} {'reloc':>6} {'lat(ns)':>8} {'p50':>7} {'p99':>7}"
    lines = [head, "-" * len(head)]
    for i in rows:
        lines.append(
            f"{series['win_idx'][i]:>6d} {series['w_reqs'][i]:>6d} "
            f"{100 * series['hit_rate'][i]:>6.1f} "
            f"{100 * series['row_hit_rate'][i]:>8.1f} "
            f"{series['w_ins'][i]:>5d} {series['w_reloc_blocks'][i]:>6d} "
            f"{series['avg_lat_ns'][i]:>8.1f} "
            f"{series['p50_ns'][i]:>7.1f} {series['p99_ns'][i]:>7.1f}")
    return "\n".join(lines)


def series_csv(series: Dict[str, np.ndarray]) -> str:
    """The full series as CSV (scalar columns only — no bank breakdown)."""
    keys = [f for f in series if series[f].ndim == 1]
    lines = [",".join(keys)]
    for i in range(len(series["win_idx"])):
        lines.append(",".join(
            f"{series[k][i]:.6g}" if series[k].dtype.kind == "f"
            else str(int(series[k][i])) for k in keys))
    return "\n".join(lines) + "\n"
