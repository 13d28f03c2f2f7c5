"""Figure 13: row-segment size sweep (8..128 blocks; the paper's peak is
at 16).

One ``simulator.sweep`` call a workload covers the grid.  The segment
size (``segs_per_row``) is a traced parameter under the padded FTS model
(DESIGN.md §3), so every FIGCache point shares one static group: two
replays a workload.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import simulator
from repro_torch.core.timing import paper_config
from repro_torch.device import resolve_device
from repro_torch.figures import common

SEG_BLOCKS = (8, 16, 32, 64, 128)


def configs(sizes: common.Sizes = common.FULL):
    return [paper_config("base")] + [
        paper_config("figcache_fast", seg_blocks=sb) for sb in SEG_BLOCKS]


def collect(device=None, sizes: common.Sizes = common.FULL):
    """``{workload index: [RunResult per config]}``."""
    return common.sweep_grid(configs(sizes), sizes, resolve_device(device))


def summarize(res):
    rows = []
    summary = {}
    sp = {sb: [] for sb in SEG_BLOCKS}
    for r in res.values():
        base = r[0]
        for sb, x in zip(SEG_BLOCKS, r[1:]):
            sp[sb].append(simulator.speedup(x, base))
    for sb in SEG_BLOCKS:
        summary[f"seg={sb}"] = round(float(np.mean(sp[sb])), 4)
        rows.append({"seg_blocks": sb, "wspeedup": summary[f"seg={sb}"]})
    return rows, summary


def run(device=None, sizes: common.Sizes = common.FULL):
    return summarize(collect(device, sizes))
