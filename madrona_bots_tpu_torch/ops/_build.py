"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C entry
point (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -shared -Xcompiler -fPIC -o build/kernels/lib<name>_<hash>.so <name>.cu

`-fmad=false` keeps every f32 multiply and add separately rounded, as the
reference arithmetic is. The library's name carries a hash of its sources
and flags, so an edited source is rebuilt and a stale library never loads.
Libraries are built at first use, or all at once (one nvcc per source, run
in parallel) by `build()`. Every build runs ptxas with `-v` and keeps its
report (registers, spills) beside the library as `lib<name>_<hash>.ptxas`,
so a library loaded from the cache still has its report. Pointers and the
stream go in as `c_void_p`; each entry point returns `cudaGetLastError()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("systems", "raycast", "row_gather")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels build on a machine "
                       "with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def report_path(name: str) -> Path:
    """ptxas's `-v` report of the library `library_path(name)`."""
    return library_path(name).with_suffix(".ptxas")


def build(names=SOURCES) -> tuple[float, str]:
    """Compile every library not built yet, one nvcc per source, all at once.
    Returns (seconds, ptxas's register and spill report of every library in
    `names`, each under a `[<name>.cu]` line, read from the kept reports)."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out, rep = library_path(name), report_path(name)
        if out.exists() and rep.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, rep, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, out, rep, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
        rep_tmp = rep.with_name(f"{rep.name}.{os.getpid()}.tmp")
        rep_tmp.write_text(log)
        os.replace(rep_tmp, rep)
        os.replace(tmp, out)
    logs = [f"[{name}.cu]\n{report_path(name).read_text()}" for name in names]
    return time.perf_counter() - t0, "".join(logs)


def function(lib: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of library `lib`, built if needed."""
    fn = _fns.get((lib, symbol))
    if fn is None:
        if lib not in _libs:
            build((lib,))
            _libs[lib] = ctypes.CDLL(str(library_path(lib)))
        fn = getattr(_libs[lib], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(lib, symbol)] = fn
    return fn
