"""Fig 17 and the tail-latency figure on the port (``repro_torch.figures``)
against the JAX package at the quick sizes on the CPU: the scenario
grid's ``RunResult``s field by field, the tail figure's cumulative
latency planes bitwise, and every row and summary exactly."""
import pytest

pytest.importorskip("torch")

import torch_figures_common as tfc  # noqa: E402
from torch_figures_common import one_thread  # noqa: E402,F401
from repro_torch.figures import common, fig_tail_latency  # noqa: E402

FIGS = ("fig17_scenarios", "fig_tail_latency")
# fig 17: one group per mechanism, the six families stacked; the tail
# figure: 6 families x 2 mechanisms x one 1024-request segment each
REPLAYS = {"fig17_scenarios": 5, "fig_tail_latency": 12}


@pytest.fixture(scope="module")
def port():
    common.clear_cache()
    return {name: tfc.port_run(name) for name in FIGS}


@pytest.mark.parametrize("name", FIGS)
def test_figure_matches_jax(port, name):
    tfc.assert_figure_matches_jax(name, port[name])


@pytest.mark.parametrize("name", FIGS)
def test_replays_per_figure(port, name):
    assert port[name][3] == REPLAYS[name]


def test_tail_latency_covers_every_request(port):
    """Each (family, mechanism) row counts every generated request, and
    its percentiles sit inside their buckets."""
    _, rows, summary, _ = port["fig_tail_latency"]
    n = 4 * common.QUICK.reqs_8core          # 4 channels, all real
    assert len(rows) == len(common.scenario_specs(common.QUICK)) * 2
    for r in rows:
        assert r["requests"] == n, r
        for q in ("p50", "p90", "p99", "p999"):
            lo, hi = r[f"{q}_bracket_ns"]
            assert lo <= r[f"{q}_ns"] <= hi, (r["family"], q)
    assert summary["p99_gain_mean"] > 0
    assert fig_tail_latency.config("base").telemetry == \
        fig_tail_latency.PERIOD
