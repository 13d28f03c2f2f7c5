"""Memory-controller scheduling subsystem, PyTorch port of
``repro.core.sched`` (DESIGN.md §10).

 * ``policies`` — per-bank request queues with pluggable disciplines
   (FCFS, FR-FCFS row-hit-first with a starvation cap, write-drain
   batching), realized as host-side trace-preprocessing permutations keyed
   by ``timing.SchedConfig``, so a whole controller grid replays through
   the same step (one ``sim_scan`` launch per group on the card).
 * ``wavefront`` — bank-parallel execution: a compile pass groups the
   (scheduled) trace into distinct-bank waves; on the CPU one eager step
   retires a whole wave, on the card the linearized waves replay through
   ``sim_scan``.  Bitwise-equal to the serial step.
"""
from repro_torch.core.sched.policies import (SCHED_FCFS, SchedConfig,
                                             StreamScheduler, frfcfs_perm,
                                             schedule, write_drain_perm)
from repro_torch.core.sched.wavefront import (form_waves, linearize_waves,
                                              make_wave_step, pad_waves,
                                              resume_waves,
                                              run_channel_waves,
                                              run_sweep_waves,
                                              simulate_waves, wave_stats)

__all__ = [
    "SCHED_FCFS", "SchedConfig", "schedule", "frfcfs_perm",
    "write_drain_perm", "StreamScheduler", "form_waves", "linearize_waves",
    "make_wave_step", "pad_waves", "resume_waves", "run_channel_waves",
    "run_sweep_waves", "simulate_waves", "wave_stats",
]
