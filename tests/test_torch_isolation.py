"""The PyTorch port stands alone: no jax and no ``repro`` import anywhere in
``src/repro_torch`` or ``chip_smoke.py``, the CUDA default never drops to
the CPU silently, and its kernel modules import without CUDA or nvcc."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import device as device_mod
from repro_torch.core import dram, timing

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_ast_walk_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "bad.py"
    f.write_text("def f():\n    from repro.core import energy\n"
                 "    import jax.numpy as jnp\n")
    assert [m for m in _imported_modules(f) if _forbidden(m)] == \
        ["repro.core", "jax.numpy"]
    f.write_text("import repro_torch.core.dram\n")
    assert not [m for m in _imported_modules(f) if _forbidden(m)]


def _tiny_trace():
    idx = np.arange(8)
    return dram.Trace(t_issue=(idx * 16).astype(np.int32),
                      bank=(idx % 2).astype(np.int32),
                      row=idx.astype(np.int32), col=idx.astype(np.int32),
                      is_write=idx % 3 == 0, core=(idx % 8).astype(np.int32))


def test_default_device_without_cuda_raises(monkeypatch):
    """``device=None`` means CUDA; without it the entry points raise rather
    than run on the CPU.  CUDA is hidden so this holds on any machine."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = timing.paper_config("figcache_fast", cache_rows=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        dram.run_channel(_tiny_trace(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cfg.params()
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mod.resolve_device("cuda")
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    cnt = dram.run_channel(_tiny_trace(), cfg, device="cpu")
    assert int(cnt.reads + cnt.writes) == 8


def test_kernel_modules_import_without_cuda_or_nvcc(tmp_path):
    """Importing the kernel wrapper builds nothing and needs no toolkit:
    run it with no nvcc on PATH and no visible CUDA device."""
    env = dict(os.environ, PATH=str(tmp_path), CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    env.pop("CUDA_HOME", None)
    env.pop("CUDA_PATH", None)
    code = ("import repro_torch.kernels.fts_lookup.fts_lookup as k, "
            "repro_torch.kernels.fts_lookup.ops, "
            "repro_torch.kernels.figaro_reloc.figaro_reloc as r, "
            "repro_torch.kernels.figaro_reloc.ops, "
            "repro_torch.kernels.figcache_decode.figcache_decode as d, "
            "repro_torch.kernels.figcache_decode.ops, "
            "repro_torch.kernels.flash_attention.flash_attention as f, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.kernels.sim_scan.sim_scan as s, "
            "repro_torch.figkv, repro_torch.launch.serve, "
            "repro_torch.models, repro_torch.convert, "
            "repro_torch.kernels._build as b, repro_torch.core.simulator\n"
            "assert k.COUNTER.launches == r.COUNTER.launches == "
            "d.COUNTER.launches == f.COUNTER.launches == "
            "s.COUNTER.launches == 0 and not b._LOADED\n"
            "assert 'jax' not in __import__('sys').modules\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
