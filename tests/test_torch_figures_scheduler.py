"""Fig 16 on the port (``repro_torch.figures.fig16_scheduler``) against
the JAX package at the quick sizes on the CPU: the controller grid's
``RunResult``s field by field, its rows and summary exactly."""
import pytest

pytest.importorskip("torch")

import torch_figures_common as tfc  # noqa: E402
from torch_figures_common import one_thread  # noqa: E402,F401
from repro_torch.figures import common, fig16_scheduler  # noqa: E402

NAME = "fig16_scheduler"


@pytest.fixture(scope="module")
def port():
    common.clear_cache()
    return tfc.port_run(NAME)


def test_figure_matches_jax(port):
    tfc.assert_figure_matches_jax(NAME, port)


def test_replays(port):
    """Two workloads x (5 controllers x {base, figcache_fast}) groups."""
    assert port[3] == 20


def test_fig16_reports_every_controller(port):
    _, rows, summary, _ = port
    assert [r["sched"] for r in rows] == [n for n, _ in
                                          fig16_scheduler.SCHEDS]
    assert list(summary) == [n for n, _ in fig16_scheduler.SCHEDS]
