"""Smoke tests for the port's runnable examples (``examples/torch_*.py``),
the cases of ``tests/test_examples.py`` on the port: each runs in-process
(``runpy``) on the CPU (``--device cpu``) with tiny traces through the
``REPRO_EXAMPLE_REQS`` knob, and prints the JAX examples' markers.
Without ``--device`` an example runs on the CUDA device or raises."""
import pathlib
import runpy

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
PORT_EXAMPLES = ("torch_quickstart.py", "torch_dram_cache_demo.py",
                 "torch_serve_decode.py", "torch_train_lm.py")


def _run(name, monkeypatch, capsys, argv=(), device="cpu"):
    monkeypatch.setenv("REPRO_EXAMPLE_REQS", "256")
    dev = ["--device", device] if device else []
    monkeypatch.setattr("sys.argv", [name, *argv, *dev])
    runpy.run_path(str(EXAMPLES / name), run_name="__main__")
    return capsys.readouterr().out


def test_quickstart_smoke(monkeypatch, capsys):
    out = _run("torch_quickstart.py", monkeypatch, capsys)
    assert "[1] mcf speedup" in out
    assert "[2] FIGARO reloc" in out and "OK" in out
    assert "[3] qwen2-7b" in out


def test_quickstart_scenario_smoke(monkeypatch, capsys):
    """``--scenario`` drives layer 1 with a device-generated workload
    (DESIGN.md §11) instead of the numpy mcf trace."""
    out = _run("torch_quickstart.py", monkeypatch, capsys,
               argv=["--scenario", "embed"])
    assert "[1] scenario=embed speedup" in out
    assert "[3] qwen2-7b" in out


def test_quickstart_telemetry_smoke(monkeypatch, capsys):
    """``--telemetry`` streams a window-collected FIGCache run and prints
    the compact per-window hit-rate table (DESIGN.md §15)."""
    out = _run("torch_quickstart.py", monkeypatch, capsys,
               argv=["--telemetry"])
    assert "[1] mcf speedup" in out
    assert "[1t] per-window telemetry" in out
    assert "hit%" in out and "rowhit%" in out


def test_dram_cache_demo_smoke(monkeypatch, capsys):
    out = _run("torch_dram_cache_demo.py", monkeypatch, capsys)
    assert "FIGARO timing" in out
    # all six §8 mechanisms must report a row
    for mech in ("base", "lisa_villa", "figcache_slow", "figcache_fast",
                 "figcache_ideal", "lldram"):
        assert mech in out
    assert "row-hit" in out


def test_serve_decode_smoke(monkeypatch, capsys):
    out = _run("torch_serve_decode.py", monkeypatch, capsys,
               argv=["--gen", "2"])
    assert "[serve] qwen2-7b: prefill 64 toks" in out
    assert "[serve]   figkv: 2 steps" in out


def test_train_lm_smoke(monkeypatch, capsys, tmp_path):
    out = _run("torch_train_lm.py", monkeypatch, capsys,
               argv=["--steps", "2", "--ckpt", str(tmp_path / "ckpt")])
    assert "[train] step     0 loss" in out
    assert "loss: " in out and "improved" in out


@pytest.mark.parametrize("name", PORT_EXAMPLES)
def test_default_device_without_cuda_raises(name, monkeypatch, capsys):
    """No ``--device``: the CUDA device, and without one a
    ``RuntimeError`` before anything runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _run(name, monkeypatch, capsys, device=None)
    assert "[1]" not in capsys.readouterr().out


def test_examples_exist():
    """The smoke tests above must track the port's example set, one
    counterpart for each JAX example."""
    have = {p.name for p in EXAMPLES.glob("*.py")}
    assert set(PORT_EXAMPLES) <= have
    assert {f"torch_{n}" for n in have if not n.startswith("torch_")} == \
        set(PORT_EXAMPLES)
