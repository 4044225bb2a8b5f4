"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's workload file names its
configuration and the loop it runs (`drivers/<name>.py`); set-up builds
the loop and warms up every shape the window uses, the window calls it for
`--seconds`, then the program's state is freed and the plain reference
decides `correct`. With
`--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read by `metrics/<name>.py` from the
window, the loop object and a device trace of `trace_calls` calls made
after the window.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()   # set-up counts from here: imports, build, warm-up

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402  (needs ROOT on the path)


class Run:
    """What a metric's reader reads: the window, the loop object and the
    trace (None in an untraced run)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def measure(workload: str, seed: int, seconds: float, trace: bool, device=None,
            config_overrides: dict | None = None) -> dict:
    """One run of `workload`: the result line as a dict. `device` None means
    the card, checked to be there; a test passes "cpu" and small sizes in
    `config_overrides`."""
    import torch

    bench = core.manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    wl = core.data("workloads", workload)
    config = {**core.data("configs", wl["config"]), **(config_overrides or {})}
    if device is None:
        if workload not in cells:
            core.die(f"no workload {workload!r} in BENCHMARK.json")
        chips = cells[workload]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            core.die(f"the cell needs {chips} CUDA device(s); torch.cuda.is_available() is "
                     f"{torch.cuda.is_available()}, device_count() "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 2)
        device = "cuda"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    readers = {m["name"]: core.plugin("metrics", m["name"])
               for m in core.cell_metrics(bench, workload, "per_layer" if trace else "end_to_end")}
    driver_mod = core.plugin("drivers", wl["driver"])

    drv = driver_mod.Driver(config, wl, seed, dev, trace)
    setup_s = time.perf_counter() - T0

    calls, steps = [], 0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        t = time.perf_counter()
        steps += drv.call()
        calls.append(time.perf_counter() - t)
    window_s = time.perf_counter() - start

    tr = None
    n_traced = wl.get("trace_calls", 0) if trace else 0
    if n_traced:
        # The process's only trace, over `trace_calls` calls after the window.
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            drv.tracing, t_ns = True, time.time_ns()
            for _ in range(n_traced):
                drv.call()
            end_ns = time.time_ns()
            drv.tracing = False
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    drv.finish()
    if n_traced:
        from portbench.trace import Trace
        tr = Trace(prof, t_ns, end_ns)
        del prof
        want = wl["launches_per_call"]
        got = {k: len(tr.durations(k)) for k in want}
        if on_card and any(got[k] != want[k] * n_traced for k in want):
            core.die(f"the trace of {n_traced} calls lacks launches: {got}, expected "
                     f"{ {k: v * n_traced for k, v in want.items()} }")

    from portbench import compare
    failed, checks = compare.judge(drv.numbers(), wl["check"]["limits"])

    run = Run(config=config, seconds=window_s, world_steps=steps,
              call_s=calls, setup_s=setup_s, driver=drv, trace=tr,
              traced_calls=n_traced)
    metrics = {}
    for m in core.cell_metrics(bench, workload, "per_layer" if trace else "end_to_end"):
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": failed == 0, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    fifths = [sorted(calls[i * len(calls) // 5:(i + 1) * len(calls) // 5]) for i in range(5)]
    print(f"window: {len(calls)} calls in {window_s:.3f} s; median ms of each fifth "
          f"{[round(1e3 * f[len(f) // 2], 3) for f in fifths if f]}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.update(core.cache_env())
    result = measure(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = core.forbidden_modules(sys.modules)
    if bad:
        core.die(f"the run imported {', '.join(bad)}")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
