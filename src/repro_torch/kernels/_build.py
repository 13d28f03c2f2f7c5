"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles on its
own into ``build/kernels/lib<name>-<hash>.so`` at the repository root, at
first use (the hash of the source keys the file, so an edited source
rebuilds); ``build_all`` starts one ``nvcc`` per source, all at once.
Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded library; one load per process and source version
_LOADED: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, ptxas report) of the builds this process ran
BUILD_LOG: Dict[str, tuple] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "compiled at first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names: Sequence[str]) -> List[Path]:
    """Compile the kernels in ``names`` that are not built yet, one ``nvcc``
    per source, all started together; their library paths.

    Raises ``RuntimeError`` with the compiler's output if a build fails.
    Each library is written to a temporary name and renamed into place, so
    a concurrent or interrupted build never leaves a half-written file."""
    paths = [_lib_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths) if not p.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
    procs = []
    for name, path in todo:
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        procs.append((name, path, tmp, time.perf_counter(), subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, path, tmp, t0, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"kernel build of {name} failed (nvcc exit "
                          f"{proc.returncode}):\n{out}")
            continue
        os.replace(tmp, path)
        BUILD_LOG[name] = (time.perf_counter() - t0, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[0]))
        _LOADED[name] = lib
    return lib
