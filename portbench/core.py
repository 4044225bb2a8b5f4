"""What every run of the benchmark shares: the manifest and the files it
names, plugin loading by file name, the import guard, and the statistics.

Everything a cell, a configuration or a metric owns sits in a file of its
own that the harness finds by the name `BENCHMARK.json` gives it:
`configs/<config>.json`, `workloads/<cell>.json`, `drivers/<driver>.py`
and `metrics/<metric>.py`. A later change adds such files and entries and
edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

FORBIDDEN = ("jax", "jaxlib", "flax", "madrona_bots_tpu")
"""Top-level module names no run may hold: the JAX package and its stack.
The port's name begins with the JAX package's, so names are compared whole."""


def forbidden_modules(names) -> list[str]:
    """The module names whose top-level part (before the first dot) is one
    of `FORBIDDEN`, compared whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def cache_env(root: Path = ROOT) -> dict[str, str]:
    """Kernel and build caches at fixed paths inside the checkout, so that
    only the first run of a cell in a checkout builds and compiles. The
    port's own kernels build into `build/kernels` (its `ops/_build.py`)."""
    build = root / "build"
    return {"TRITON_CACHE_DIR": str(build / "triton"),
            "TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
            "CUDA_CACHE_PATH": str(build / "cuda_cache"),
            "USE_FLAX": "0"}


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def data(kind: str, name: str) -> dict:
    """`portbench/<kind>/<name>.json`: a configuration or a workload."""
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def plugin(kind: str, name: str):
    """The module `portbench/<kind>/<name>.py`, loaded from its file (a
    metric's name holds dots, so it is not an import path)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, section: str) -> list[dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that the cell
    reports: those without a `workloads` list, and those whose list names
    it."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the two
    nearest ranks of the sorted values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def sync(device) -> None:
    """Wait for the device (a no-op on the CPU)."""
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def die(msg: str, code: int = 1) -> None:
    """End the run without a result line."""
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)
