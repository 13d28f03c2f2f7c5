"""A run on the CPU at a tiny size, with the timed path broken underneath,
has to come out as not correct; so has the control (the reference at
whole nanoseconds in the program's place).  The look for a chip is
skipped (the device is the CPU), the rest of a run is driven as on the
card: set-up, warm-up, window, reference, comparison."""
import sys
import time
import types

import pytest
import torch

from perfbench import controls, harness
from repro_torch.core import dram

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
PATCH = {"workloads": {"eight_core_mixes": [5, 17]}}
# (configuration patch, traffic patch) of each cell at a tiny size
SMALL = {
    "ddr4-8core.paper-grid": ({"requests_per_channel": 48}, PATCH),
    "ddr4-1core.paper-grid": ({"requests_per_channel": 96}, {}),
    "ddr4-8core.design-sweep": ({"requests_per_channel": 48}, {
        **PATCH, "grid": {"cross": {"mechanism": "figcache_fast",
                                    "cache_rows": [1, 64],
                                    "seg_blocks": [8, 128],
                                    "insert_threshold": [1, 4]},
                          "mechanisms": ["base"]}}),
}


def run(cell="ddr4-8core.paper-grid", seed=2_718_281_828_459, trace=False):
    config_patch, traffic_patch = SMALL[cell]
    return harness.run_cell(BENCH, cell, seed, 0.05, trace,
                            lambda chips: torch.device("cpu"),
                            time.perf_counter(), config_patch=config_patch,
                            traffic_patch=traffic_patch, workers=0,
                            check_imports=False)


def test_a_sound_run_is_correct():
    out = run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert {"sim_req_per_s", "job_p95_ms", "setup_s"} <= set(out["metrics"])


def test_a_traced_run_reads_its_layers():
    out = run(seed=31, trace=True)
    assert out["correct"], out["checks"]
    assert out["device"]["window_s"] > 0
    assert out["metrics"]["dispatch.launches_per_job"]["value"] == 0.0
    assert out["metrics"]["dispatch.host_ms_per_job"]["value"] > 0
    assert "sim_scan.longest_us_per_step" not in out["metrics"]  # no kernel
    assert "sim_scan_roofline" not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    monkeypatch.setattr(dram, "_advance", lambda trace, static, params,
                        state, variant, device, with_frames=False:
                        dram.clone_state(state, device))
    out = run()
    assert not out["correct"]
    assert out["checks"]["counters_mismatched"]["value"] > 0


def _wrap_run_sweep(monkeypatch, after):
    real = dram.run_sweep

    def broken(trace, static, params_batch, variant="fused", device=None):
        return after(real, trace, static, params_batch, variant, device)

    monkeypatch.setattr(dram, "run_sweep", broken)


def test_half_of_the_batch_left_out(monkeypatch):
    """The replay runs the first half of its lanes (workloads stacked on
    the channel axis); the other half gets their mean."""
    def half(real, trace, static, params, variant, device):
        C = trace.t_issue.shape[0]
        keep = C // 2
        cnt = real(dram.Trace(*[x[:keep] for x in trace]), static, params,
                   variant, device)
        out = []
        for x in cnt:
            mean = x.to(torch.int64).sum(1, keepdim=True) // keep
            rest = mean.expand((x.shape[0], C - keep) + tuple(x.shape[2:]))
            out.append(torch.cat([x, rest.to(x.dtype)], dim=1))
        return dram.Counters(*out)

    _wrap_run_sweep(monkeypatch, half)
    out = run()
    assert not out["correct"]
    assert out["checks"]["counters_mismatched"]["value"] > 0


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    def altered(real, trace, static, params, variant, device):
        cnt = real(trace, static, params, variant, device)
        cnt.row_hits[0, 0] += 1
        return cnt

    _wrap_run_sweep(monkeypatch, altered)
    out = run()
    assert not out["correct"]
    assert out["checks"]["counters_mismatched"]["value"] > 0


def test_a_program_that_raises_fails_the_run(monkeypatch):
    def fails(real, *args):
        raise RuntimeError("planted")

    _wrap_run_sweep(monkeypatch, fails)
    with pytest.raises(RuntimeError, match="planted"):
        run()                                  # the warm-up raises first


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_comes_out_not_correct(cell):
    config_patch, traffic_patch = SMALL[cell]
    out = controls.control_numbers(BENCH, cell, 1_618_033_988_749, 0,
                                   config_patch, {**traffic_patch, "pool": 1})
    assert not out["correct"]
    assert out["numbers"]["counters_mismatched"] > 0
    assert out["numbers"]["results_max_rel_gap"] > 0


def test_a_jax_module_in_the_process_is_found(monkeypatch):
    for name in ("jax", "repro.core", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "repro_torch_extra",
                        types.ModuleType("repro_torch_extra"))
    found = harness.forbidden_modules()
    assert {"jax", "repro.core", "flax"} <= set(found)
    assert "repro_torch_extra" not in found


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_short_run_on_the_card(cuda_device):
    import json
    import subprocess
    done = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "ddr4-1core.paper-grid", "--seed", "9007199254740993",
         "--seconds", "2", "--trace", "1"], cwd=harness.ROOT,
        capture_output=True, text=True, timeout=360)
    assert done.returncode == 0, done.stderr[-2000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0
