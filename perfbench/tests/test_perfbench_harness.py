"""The harness takes everything of a job from its driver: a driver with
other numbers, limits and counters than the simulator's runs through it
unchanged; the metric readers work from a timeline alone."""
import time
import types

import torch

from perfbench import check, harness, trace

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


class _Job:
    """A job of another kind: its own numbers and limits, no counters."""
    pool = [0, 1]
    requests = [10, 20]

    def __init__(self, gap):
        self.gap = gap

    def run(self, k):
        return k

    def reference(self, workers):
        return {0: 0, 1: 1}

    def check(self, done, expected):
        wrong = sum(res != expected[k] for k, res in done)
        return {"answers_wrong": (wrong, 0), "logit_gap": (self.gap, 0.5)}


def _driver(gap):
    return types.SimpleNamespace(
        start=lambda cfg, traffic, seed, ex: (lambda: None),
        setup=lambda cfg, traffic, seed, device, pending, mark: _Job(gap))


def _run(monkeypatch, gap):
    real = harness.load_file
    monkeypatch.setattr(harness, "load_file", lambda kind, name: _driver(
        gap) if kind == "drivers" else real(kind, name))
    return harness.run_cell(BENCH, "ddr4-8core.paper-grid", 5, 0.02, False,
                            lambda chips: torch.device("cpu"),
                            time.perf_counter(), workers=0,
                            check_imports=False)


def test_a_driver_brings_its_own_numbers_and_limits(monkeypatch):
    out = _run(monkeypatch, 0.25)
    assert out["correct"]
    assert out["checks"] == {"answers_wrong": {"value": 0, "limit": 0},
                             "logit_gap": {"value": 0.25, "limit": 0.5},
                             "jobs_failed": {"value": 0, "limit": 0}}
    assert out["metrics"]["sim_req_per_s"]["value"] > 0


def test_a_driver_number_over_its_limit_is_not_correct(monkeypatch):
    assert not _run(monkeypatch, 0.75)["correct"]


def test_verdict_needs_a_number():
    assert not check.verdict({})
    assert check.verdict({"a": (0, 0), "b": (0.1, 0.2)})
    assert not check.verdict({"a": (1, 0)})
    assert check.WORKERS >= 1


def _ctx(device, jobs, T=100, launches=None):
    tl = trace.Timeline(jobs, device, [])
    job = types.SimpleNamespace(steps_per_launch=T, bytes_per_job=3.35e6)
    return types.SimpleNamespace(tl=tl, job=job, n_jobs=len(jobs),
                                 counters={} if launches is None else
                                 {"sim_scan.launches": launches})


def test_the_longest_launch_of_each_job_sets_the_step_time():
    k = "void sim_scan_kernel<false>(sim::Args)"
    device = [(k, 0, 1000), (k, 1000, 9000), ("memcpy", 9000, 9500),
              (k, 20000, 24000), (k, 24000, 25000)]
    ctx = _ctx(device, [(0, 10000), (20000, 26000)])
    read = harness.load_file("metrics", "sim_scan.longest_us_per_step").read
    # (8000 + 4000) / 2 ns over 100 steps
    assert read(ctx) == 6000 / 100 / 1e3
    assert read(_ctx([("memcpy", 0, 5)], [(0, 10)])) is None


def test_kernel_metrics_are_silent_without_their_inputs():
    k = "sim_scan_kernel"
    roof = harness.load_file("metrics", "sim_scan_roofline").read
    launches = harness.load_file("metrics", "dispatch.launches_per_job").read
    ctx = _ctx([(k, 0, 1000)], [(0, 2000)], launches=4)
    # 3.35e6 bytes at 3.35e12 B/s: 1 us of 1 us
    assert abs(roof(ctx) - 100.0) < 1e-9
    assert launches(ctx) == 4.0
    ctx.job = types.SimpleNamespace()
    ctx.counters = {}
    assert roof(ctx) is None and launches(ctx) is None

