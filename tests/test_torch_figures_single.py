"""Figs 3 and 7 on the port (``repro_torch.figures``) against the JAX
package at the quick sizes on the CPU: the footprint profiles and the
single-core ``RunResult``s field by field, the rows and summaries exactly;
and the figures' entry point without CUDA."""
import pytest

torch = pytest.importorskip("torch")

import torch_figures_common as tfc  # noqa: E402
from torch_figures_common import one_thread  # noqa: E402,F401
from repro_torch.figures import __main__ as cli  # noqa: E402
from repro_torch.figures import common, fig07_single_core  # noqa: E402

FIGS = ("fig03_footprint", "fig07_single_core")
# replays a figure makes: none for fig 3 (no simulation), one per static
# group for fig 7 (six mechanisms, the six apps stacked on the channels)
REPLAYS = {"fig03_footprint": 0, "fig07_single_core": 6}


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


def test_fig07_covers_both_classes(port):
    _, rows, summary, _ = port["fig07_single_core"]
    assert {r["class"] for r in rows} == {"intensive", "non-intensive"}
    assert len(rows) == len(fig07_single_core.APPS) * 5
    assert summary["intensive/figcache_fast"] > 1.0


def test_default_device_without_cuda_raises(monkeypatch, capsys):
    """``python -m repro_torch.figures`` and ``run()`` default to CUDA and
    raise without it rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--quick", "--only", "fig15_insertion"])
    assert "fig15_insertion" not in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="CUDA"):
        fig07_single_core.run(sizes=common.QUICK)


def test_unknown_figure_is_refused(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--only", "fig99_nothing", "--device", "cpu"])
    assert "fig99_nothing" in capsys.readouterr().err
