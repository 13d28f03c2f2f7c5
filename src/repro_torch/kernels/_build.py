"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles on its
own into ``build/kernels/lib<name>-<hash>.so`` at the repository root, at
first use (the hash of the source, of every ``csrc/*.cuh`` header and of
the flags keys the file, so an edited source or header rebuilds), with
nvcc's output (ptxas's report) beside it in ``lib<name>-<hash>.log``;
``build_all`` starts one ``nvcc`` per source, all at once.
``build_host`` compiles a ``csrc/<name>.cpp`` with the host C++ compiler
the same way (the CPU tests' build of the simulator step).  ``load`` and
``load_host`` are the only places that open a library: each opens it once
per process and keeps it in ``_LOADED``.
Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
HOST_DIR = BUILD_DIR.parent / "host"

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


def _key(source: Path, flags: Sequence[str]) -> str:
    """Hash of a source, every header in ``csrc/`` (any source may include
    any of them) and the compiler flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:12]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_key(CSRC / f'{name}.cu', NVCC_FLAGS)}.so"


def _compile(jobs) -> None:
    """Run ``(name, library path, command without -o)`` jobs at once; each
    library and its log are written to temporary names and renamed into
    place, the log first.  Raises ``RuntimeError`` with the compiler's
    output if any fails."""
    procs = []
    for name, path, cmd in jobs:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        procs.append((name, path, tmp, time.perf_counter(), cmd[0],
                      subprocess.Popen([*cmd, "-o", str(tmp)],
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, path, tmp, t0, compiler, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"kernel build of {name} failed ({compiler} exit "
                          f"{proc.returncode}):\n{out}")
            continue
        tmp_log = tmp.with_suffix(f".logtmp{os.getpid()}")
        tmp_log.write_text(out)
        os.replace(tmp_log, path.with_suffix(".log"))
        os.replace(tmp, path)
        BUILD_LOG[name] = (time.perf_counter() - t0, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_host(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` with the host C++ compiler (``g++`` or
    ``c++``) into ``build/host/lib<name>-<hash>.so`` unless built; its
    path.  Raises ``RuntimeError`` when there is no compiler."""
    src = CSRC / f"{name}.cpp"
    path = HOST_DIR / f"lib{name}-{_key(src, HOST_FLAGS)}.so"
    if not (path.exists() and path.with_suffix(".log").exists()):
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError(f"no host C++ compiler to build {name}")
        _compile([(name, path, [cxx, *HOST_FLAGS, str(src)])])
    return path


def build_all(names: Sequence[str]) -> List[Path]:
    """Compile the kernels in ``names`` that are not built yet (no library
    or no log beside it), one ``nvcc`` per source, all started together;
    their library paths.

    Raises ``RuntimeError`` with the compiler's output if a build fails.
    Each library and log is written to a temporary name and renamed into
    place, the log first, so a concurrent or interrupted build never leaves
    a half-written file or a library without its log."""
    paths = [_lib_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths)
            if not (p.exists() and p.with_suffix(".log").exists())]
    if todo:
        nvcc = _nvcc()
        _compile([(n, p, [nvcc, *NVCC_FLAGS, str(CSRC / f"{n}.cu")])
                  for n, p in todo])
    return paths


def _open(key: str, build) -> ctypes.CDLL:
    lib = _LOADED.get(key)
    if lib is None:
        lib = _LOADED[key] = ctypes.CDLL(str(build()))
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    return _open(name, lambda: build_all([name])[0])


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library of ``csrc/<name>.cpp``, building it if
    needed."""
    return _open(f"host/{name}", lambda: build_host(name))


def load_count() -> int:
    """Libraries this process has opened."""
    return len(_LOADED)


def ptxas_report(name: str, entry: str) -> Dict[str, int]:
    """What ptxas said of the kernel whose mangled name contains ``entry``
    in the current build of ``name`` (built now if needed, else read from
    the log beside the library): registers, spill stores and loads
    (bytes), and how many "Potential Performance Loss" notes."""
    build_all([name])
    text = _lib_path(name).with_suffix(".log").read_text()
    cur, rep = None, {"registers": None, "spill_stores": None,
                      "spill_loads": None, "perf_notes": 0}
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
        if "Performance Loss" in line and entry in line:
            rep["perf_notes"] += 1
        if cur is None or entry not in cur:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rep["spill_stores"], rep["spill_loads"] = int(m[1]), int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rep["registers"] = int(m[1])
    return rep
