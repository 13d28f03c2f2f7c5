"""DRAM + system energy model (paper §7: DRAMPower/McPAT/CACTI-style).

A verbatim numpy copy of ``repro.core.energy`` for the PyTorch port.

Constants are rank-level per-operation energies chosen to be internally
consistent with the paper's own numbers: §4.2 gives 0.03 uJ (30 nJ) for one
isolated cache-block relocation = 2 ACT+PRE pairs + 1 RELOC, which pins
E_ACT_PRE ≈ 13 nJ and E_RELOC_BLOCK ≈ 4 nJ.  Fast-subarray activations are
cheaper (shorter bitlines).  The CPU/cache/interconnect side is a lumped
per-instruction + static model (DESIGN.md §7) used only for the Figure 11
system-energy breakdown.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    e_act_pre: float = 13.5       # nJ, slow-subarray ACT+PRE (rank)
    e_act_pre_fast: float = 8.0   # nJ, fast-subarray ACT+PRE
    e_rd: float = 12.0            # nJ per 64 B read burst (incl. I/O + bus)
    e_wr: float = 13.0            # nJ per 64 B write burst
    e_reloc_block: float = 1.0    # nJ per RELOC'd block: internal GRB column
                                  # transfer, no I/O drivers / channel bus
                                  # (2*13.5 + ~1 + margin ≈ the paper's 30 nJ
                                  # isolated-relocation figure, §4.2)
    p_bg: float = 0.40            # W background per channel (rank standby)
    # system side (fig. 11 breakdown)
    e_cpu_instr: float = 0.60     # nJ dynamic per instruction (core+L1/L2)
    p_cpu_static: float = 2.5     # W static per core (incl. LLC share)
    e_offchip_req: float = 2.0    # nJ per memory request on the bus

    def dram_energy_nj(self, counters, n_channels: int,
                       exec_time_ns: float | None = None) -> dict:
        """Background energy scales with *execution* time — shorter runtime
        is one of the paper's two energy-saving sources (§8.2)."""
        c = counters
        tot = lambda x: float(x.sum()) if hasattr(x, "sum") else float(x)
        if exec_time_ns is None:
            exec_time_ns = tot(c.t_end) / 8.0 if n_channels == 1 else \
                float(max(c.t_end)) / 8.0
        dyn = (tot(c.acts_slow) * self.e_act_pre
               + tot(c.acts_fast) * self.e_act_pre_fast
               + tot(c.insertions) * self.e_act_pre_fast  # RELOC dst ACT
               + tot(c.reads) * self.e_rd
               + tot(c.writes) * self.e_wr
               + (tot(c.reloc_blocks) + tot(c.wb_blocks)) * self.e_reloc_block)
        bg = exec_time_ns * self.p_bg * n_channels
        return {"dram_dynamic": dyn, "dram_background": bg,
                "dram_total": dyn + bg}

    def system_energy_nj(self, counters, n_channels: int, n_cores: int,
                         instructions: float, exec_time_ns: float) -> dict:
        d = self.dram_energy_nj(counters, n_channels, exec_time_ns)
        c = counters
        tot = lambda x: float(x.sum()) if hasattr(x, "sum") else float(x)
        reqs = tot(c.reads) + tot(c.writes)
        cpu = instructions * self.e_cpu_instr \
            + exec_time_ns * self.p_cpu_static * n_cores
        off = reqs * self.e_offchip_req
        return {**d, "cpu": cpu, "offchip": off,
                "system_total": d["dram_total"] + cpu + off}

    def system_energy_nj_batch(self, counters, n_channels: int, n_cores: int,
                               instructions, exec_time_ns, tot) -> dict:
        """Vectorized over a leading params axis P (sweep post-processing).

        ``counters`` leaves are shaped (P, ...); ``instructions`` and
        ``exec_time_ns`` are (P,) float64; ``tot`` reduces a counter leaf to
        (P,) totals.  Mirrors the scalar formulas term for term, returning a
        dict of (P,) arrays."""
        c = counters
        dyn = (tot(c.acts_slow) * self.e_act_pre
               + tot(c.acts_fast) * self.e_act_pre_fast
               + tot(c.insertions) * self.e_act_pre_fast  # RELOC dst ACT
               + tot(c.reads) * self.e_rd
               + tot(c.writes) * self.e_wr
               + (tot(c.reloc_blocks) + tot(c.wb_blocks)) * self.e_reloc_block)
        bg = np.asarray(exec_time_ns, np.float64) * self.p_bg * n_channels
        cpu = np.asarray(instructions, np.float64) * self.e_cpu_instr \
            + np.asarray(exec_time_ns, np.float64) * self.p_cpu_static * n_cores
        off = (tot(c.reads) + tot(c.writes)) * self.e_offchip_req
        return {"dram_dynamic": dyn, "dram_background": bg,
                "dram_total": dyn + bg, "cpu": cpu, "offchip": off,
                "system_total": dyn + bg + cpu + off}


ENERGY = EnergyModel()
