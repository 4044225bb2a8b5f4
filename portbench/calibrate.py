"""The readings that the limits of `correct` are set from, on the card at
the cell's own size:

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... [--control 1 2 3]

For each seed of `--seeds` the program's numbers, as a run's check computes
them, after enough calls to reach every kept step; for each seed of
`--control` also the control's: the reference in the precision below the
configuration's (bf16 for the world's f32 floats), put in the program's
place. One JSON line a seed, then one with each number's largest program
reading and smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402

CONTROL = {"f32": "bfloat16"}
"""The precision below each configuration's `dtype`."""


def readings(workload: str, seed: int, control: bool, device: str = "cuda",
             config_overrides: dict | None = None, wl: dict | None = None) -> dict:
    """One seed's readings; a test passes the CPU, small sizes and an edited
    workload `wl`."""
    import torch

    wl = wl or core.data("workloads", workload)
    config = {**core.data("configs", wl["config"]), **(config_overrides or {})}
    drv = core.plugin("drivers", wl["driver"]).Driver(config, wl, seed, torch.device(device),
                                                      False)
    while drv.calls <= max(drv.check_at):
        drv.call()
    drv.finish()
    out = {"seed": seed, "program": drv.numbers()}
    if control:
        out["control"] = drv.numbers(quant=getattr(torch, CONTROL[config["dtype"]]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    os.environ.update(core.cache_env())
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        row = readings(args.workload, seed, seed in args.control)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for name in rows[0]["program"]:
        vals = [r["program"][name] for r in rows if r["program"][name] is not None]
        summary[name] = {"program_max": max(vals) if vals else None}
        vs = [r["control"][name] for r in rows if "control" in r and r["control"][name] is not None]
        if vs:
            summary[name]["control_min"] = min(vs)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
