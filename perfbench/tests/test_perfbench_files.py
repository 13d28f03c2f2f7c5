"""``BENCHMARK.json`` against the rules of its format (keys, names, units,
bounds), and every configuration, traffic mix, driver and metric it names
found and loaded by name."""
import json
import re

import pytest

from perfbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads") for x in BENCH[k]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    _, entry, cfg, traffic = harness.cell_of(BENCH, cell)
    assert cfg["name"] == entry["name"]
    assert set(entry["reduced"]) <= set(cfg)
    driver = harness.load_file("drivers", traffic["driver"])
    assert callable(driver.setup) and callable(driver.start)
    for trace in (False, True):
        assert harness.metrics_for(BENCH, cell, trace)


@pytest.mark.parametrize("metric", [m["name"] for k in ("end_to_end",
                                                        "per_layer")
                                    for m in BENCH[k]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.load_file("metrics", metric).read)


def test_a_roofline_share_is_named_for_its_kernel():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_configs_and_traffic_are_plain_json():
    for path in list((harness.BENCH / "configs").glob("*.json")) + \
            list((harness.BENCH / "traffic").glob("*.json")):
        json.loads(path.read_text())
