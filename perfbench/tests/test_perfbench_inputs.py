"""The benchmark's frozen trace generator against the program's today,
and its byte count against ``chip_smoke.state_bytes``."""
import dataclasses

import numpy as np
import pytest

from perfbench import roofline, tracegen
from repro_torch.core import traces


def test_app_lists_and_mixes_equal_the_programs():
    assert tracegen.INTENSIVE == traces.INTENSIVE
    assert tracegen.NON_INTENSIVE == traces.NON_INTENSIVE
    ours, theirs = tracegen.eight_core_workloads(), \
        traces.eight_core_workloads()
    assert [(n, f) for n, f, _ in ours] == [(n, f) for n, f, _ in theirs]
    for (_, _, a), (_, _, b) in zip(ours, theirs):
        assert [dataclasses.asdict(x) for x in a] == \
            [dataclasses.asdict(x) for x in b]


@pytest.mark.parametrize("apps,channels,per_channel,seed", [
    ((5,), 4, 512, 2),                     # a fig-8 mix, the figures' seed
    ((17,), 4, 256, 3_000_000_007),        # a large --seed-drawn seed
    (("mcf",), 1, 700, 4_294_967_295),     # one app alone on one channel
    (("tpch2",), 1, 300, 1),
])
def test_build_trace_equals_the_programs(apps, channels, per_channel, seed):
    mixes = tracegen.eight_core_workloads()
    if isinstance(apps[0], int):
        ours = mixes[apps[0]][2]
        theirs = traces.eight_core_workloads()[apps[0]][2]
    else:
        ours = [tracegen.app_params(apps[0])]
        theirs = [traces.app_params(apps[0])]
    got = tracegen.build_trace(ours, channels, per_channel, seed)
    want = traces.build_trace(theirs, channels, per_channel, seed)
    for f in tracegen.TRACE_FIELDS:
        np.testing.assert_array_equal(got[f], getattr(want, f))
        assert got[f].dtype == getattr(want, f).dtype


def test_state_bytes_equals_chip_smoke_at_the_fig8_shape():
    chip_smoke = pytest.importorskip("chip_smoke")
    from repro_torch.core import dram, timing
    for mech in ("figcache_fast", "base"):
        cfg = timing.paper_config(mech)
        st = cfg.static
        z = np.zeros((32, 6144), np.int32)
        flat = dram.Trace(z, z, z, z, z.astype(bool), z)
        params = timing.stack_params([cfg.params(device="cpu")])
        state = dram.sim_init(st, channels=32, device="cpu")
        tr, lp, (bank, cnt, _) = dram._prepare(flat, params, state, "cpu")
        want = chip_smoke.state_bytes(tr, lp, bank, cnt, st.has_cache)
        assert roofline.state_bytes(
            6144, 32, has_cache=st.has_cache, max_slots=st.max_slots,
            max_segs_per_row=st.max_segs_per_row) == want
