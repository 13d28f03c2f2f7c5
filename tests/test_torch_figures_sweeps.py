"""Figs 12-15 on the port (``repro_torch.figures``) against the JAX
package at the quick sizes on the CPU: every sweep's ``RunResult``s field
by field, rows and summaries exactly; the summaries also equal what the
JAX package's own figure scripts print at these sizes; and
``python -m repro_torch.figures`` prints its ``name,derived`` line."""
import json
import runpy
import sys

import pytest

pytest.importorskip("torch")

import torch_figures_common as tfc  # noqa: E402
from torch_figures_common import one_thread  # noqa: E402,F401
from repro_torch.figures import common, fig12_capacity  # noqa: E402

FIGS = ("fig12_capacity", "fig13_segment_size", "fig14_replacement",
        "fig15_insertion")
# two workloads x the grid's static groups: base + one figcache_fast group
# (capacity, segment size and threshold are traced), or base + one group
# per replacement policy
REPLAYS = {"fig12_capacity": 4, "fig13_segment_size": 4,
           "fig14_replacement": 10, "fig15_insertion": 4}
# `python -m benchmarks.run --quick`'s summaries of these figures (the JAX
# package's figure scripts at the quick sizes)
SCRIPT_SUMMARIES = {
    "fig12_capacity": {"FS=1": 1.1137, "FS=2": 1.1846, "FS=4": 1.1991,
                       "FS=8": 1.1991, "FS=16": 1.1991},
    "fig13_segment_size": {"seg=8": 1.1214, "seg=16": 1.1802,
                           "seg=32": 1.0691, "seg=64": 0.9056,
                           "seg=128": 0.6679},
    "fig14_replacement": {"row_benefit": 1.1991, "segment_benefit": 1.1991,
                          "lru": 1.1991, "random": 1.1991},
    "fig15_insertion": {"th=1": 1.1802, "th=2": 1.1577, "th=4": 1.0816,
                        "th=8": 1.035},
}


@pytest.fixture(scope="module")
def port():
    common.clear_cache()
    return {name: tfc.port_run(name) for name in FIGS}


@pytest.mark.parametrize("name", FIGS)
def test_figure_matches_jax(port, name):
    tfc.assert_figure_matches_jax(name, port[name])


@pytest.mark.parametrize("name", FIGS)
def test_summary_matches_the_figure_script(port, name):
    assert port[name][2] == SCRIPT_SUMMARIES[name]


@pytest.mark.parametrize("name", FIGS)
def test_replays_per_figure(port, name):
    assert port[name][3] == REPLAYS[name]


def test_capacity_rows_shrink_at_quick_sizes():
    """At the quick sizes fig 12 divides ``cache_rows`` by 4, as the JAX
    script does under ``--quick``; at the full sizes it does not."""
    quick = [c.cache_rows for c in fig12_capacity.configs(common.QUICK)[1:]]
    full = [c.cache_rows for c in fig12_capacity.configs(common.FULL)[1:]]
    assert full == [cr for _, cr in fig12_capacity.POINTS]
    assert quick == [max(1, cr // 4) for cr in full]


def test_cli_prints_name_and_headline(port, monkeypatch, capsys, tmp_path):
    """``python -m repro_torch.figures --quick --device cpu --only
    fig15_insertion``: the header, one ``name,derived`` line with the
    headline (``th=1``), the summary on stderr and the JSON file."""
    out = tmp_path / "figs.json"
    # run the module fresh, as `python -m` does, whatever imported it before
    monkeypatch.delitem(sys.modules, "repro_torch.figures.__main__",
                        raising=False)
    monkeypatch.setattr("sys.argv", [
        "repro_torch.figures", "--quick", "--device", "cpu", "--only",
        "fig15_insertion", "--json", str(out)])
    with pytest.raises(SystemExit) as exit_:
        runpy.run_module("repro_torch.figures", run_name="__main__")
    assert exit_.value.code == 0
    cap = capsys.readouterr()
    assert cap.out.splitlines() == ["name,derived", "fig15_insertion,1.1802"]
    assert "fig15_insertion {'th=1': 1.1802" in cap.err
    got = json.loads(out.read_text())
    assert got["sizes"] == "quick" and got["device"] == "cpu"
    assert got["figures"]["fig15_insertion"]["summary"] == \
        SCRIPT_SUMMARIES["fig15_insertion"]
    assert got["figures"]["fig15_insertion"]["rows"] == \
        port["fig15_insertion"][1]
