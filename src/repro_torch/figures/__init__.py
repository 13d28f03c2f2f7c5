"""The paper's figures on the port: figs 3, 7-17 and the tail-latency
figure, each a module with ``run(device=None, sizes=common.FULL) ->
(rows, summary)`` (counterparts of ``benchmarks/fig*.py``).

    python -m repro_torch.figures [--quick] [--only a,b] [--device cpu]

Each module splits into ``collect`` (the ``RunResult``s, profiles or
latency histograms, made on the device) and ``summarize`` (pure numpy
over what ``collect`` returns), so the same summary code can read results
made by another implementation of the simulator.  Every replay runs
through ``core/dram.py:_advance``: one ``sim_scan`` launch per static
group or stream segment on the card, the eager loop on the CPU.
"""
from repro_torch.figures.common import FULL, QUICK, Sizes  # noqa: F401

NAMES = ("fig03_footprint", "fig07_single_core", "fig08_eight_core",
         "fig09_cache_hit", "fig10_row_hit", "fig11_energy",
         "fig12_capacity", "fig13_segment_size", "fig14_replacement",
         "fig15_insertion", "fig16_scheduler", "fig17_scenarios",
         "fig_tail_latency")
