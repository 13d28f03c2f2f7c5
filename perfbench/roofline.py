"""Peaks of the chip and the bytes a ``sim_scan`` replay must move.

Peaks: NVIDIA's H100 SXM data sheet (dense rates, at the 700 W power
limit); a roofline share is stated against them with the card's power
limit beside it.

``state_bytes`` is the rule of ``chip_smoke.state_bytes``, counted from
shapes alone: the trace and the params read once; every state and counter
leaf the replay updates read once and written once, the free list (never
written) read once; the tag store's leaves only where the mechanism has a
cache.  The simulator does no floating-point work, so its roofline is the
byte bound alone.
"""
from __future__ import annotations

H100_HBM_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet

I32, BOOL = 4, 1
N_TRACE_I32 = 5                     # t_issue, bank, row, col, core
N_TRACE_BOOL = 1                    # is_write
N_PARAMS = 15                       # MechParams leaves, (N,) int32
N_TRACK = 256                       # miss trackers per bank
N_MSHR = 8


def state_bytes(T: int, N: int, *, has_cache: bool, max_slots: int,
                max_segs_per_row: int, n_banks: int = 16,
                n_cores: int = 8) -> int:
    """Bytes one replay of a (T, N) lane trace must move (see above)."""
    S, MS, nb, nc = max_slots, max_segs_per_row, n_banks, n_cores
    n = T * N * (N_TRACE_I32 * I32 + N_TRACE_BOOL * BOOL)
    n += N * N_PARAMS * I32
    updated = [N * nb * I32, N * nb * I32,            # open_row, busy
               N * nc * N_MSHR * I32, N * nc * I32,   # mshr_ring, mshr_idx
               N * I32]                               # bus_free
    updated += [N * I32] * 9 + [N * nc * I32] * 2 + [N * I32]  # Counters
    read_only = []
    if has_cache:
        updated += [N * nb * S * I32,                 # tags
                    N * nb * S * BOOL, N * nb * S * BOOL,   # valid, dirty
                    N * nb * S * I32, N * nb * S * I32,     # benefit, last
                    N * nb * I32, N * nb * MS * BOOL,  # evict row / mask
                    N * nb * N_TRACK * I32, N * nb * N_TRACK * I32,
                    N * nb * S * I32,                 # row_sum
                    N * nb * I32]                     # n_valid
        read_only += [N * nb * S * I32]               # free_list
    return n + 2 * sum(updated) + sum(read_only)


def least_seconds(n_bytes: int) -> float:
    """The least time the card needs to move ``n_bytes`` at its peak."""
    return n_bytes / H100_HBM_BYTES_PER_S
