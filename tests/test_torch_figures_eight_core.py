"""Figs 8-11 on the port (``repro_torch.figures``) against the JAX package
at the quick sizes on the CPU: the eight-core batch's ``RunResult``s field
by field, every figure's rows and summary exactly, and the one batch that
figs 9-11 read from fig 8's cache."""
import pytest

pytest.importorskip("torch")

import torch_figures_common as tfc  # noqa: E402
from torch_figures_common import one_thread  # noqa: E402,F401
from repro_torch.figures import common  # noqa: E402

FIGS = ("fig08_eight_core", "fig09_cache_hit", "fig10_row_hit",
        "fig11_energy")
# fig 8 replays one static group per mechanism (the eight workloads stacked
# on the channels); figs 9-11 read its cached batch
REPLAYS = {"fig08_eight_core": 6, "fig09_cache_hit": 0, "fig10_row_hit": 0,
           "fig11_energy": 0}


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


def test_figs_9_to_11_share_fig_8s_batch(port):
    batch = port["fig08_eight_core"][0]
    assert sorted(batch) == sorted(common.ALL_WL)
    for name in FIGS[1:]:
        assert port[name][0] is batch


def test_cache_keys_on_sizes_and_device(port):
    """The same figure at other sizes is another entry, not a hit."""
    keys = [k for k in common._CACHE if k[0] == "eight_core_batch"]
    assert len(keys) == 1 and keys[0][2:] == (common.QUICK, "cpu")
