"""Time the port's kernels with chip_smoke.py's timer, to compare two
checkouts of the repo on one CUDA card.

    python3 kernel_times.py [--root DIR] [--label NAME]

Imports madrona_bots_tpu_torch from DIR (default: the directory of this
script), builds its kernels, and makes chip_smoke.py's inputs at 8192 x
128: the state after 16 plain steps of heavy shoot/breed, and the state
with every slot alive. Prints one JSON line: for each entry, the ms per
call of each of 5 batches (CUDA events) and their median, which is
chip_smoke.py's `ms`, and chip_smoke.py's `device_ms` and `host_ms`.

`step_systems` is `ops/step_cuda.py::fused_step_systems(state, cfg)`, which
every checkout has, on the stepped state: 5 batches of 10 calls, each on
its own clone made before the batch's first event, so one timer covers a
checkout's whole systems step, whether it is a torch pre-pass, a kernel and
a torch post-pass or one launch; its `device_ms` sums every CUDA kernel
the calls ran. `systems` (a checkout that still has the separate systems
kernel `step_cuda.systems`: that kernel alone on the pre-pass's outputs),
the raycast on the stepped and on the saturated state, and the row gather
of the bf16 A2C tick's seven fields with 10 learner rows per class on the
stepped state take 5 batches of 50 launches. The inputs depend only on the
plain path, so two checkouts whose plain paths agree get the same inputs;
run it for both in one call in turns (parent, change, change, parent).
Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

import chip_smoke  # before DIR goes on the path: DIR may hold its own chip_smoke.py


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="directory that holds the madrona_bots_tpu_torch to time")
    ap.add_argument("--label", default="", help="name printed with the times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import madrona_bots_tpu_torch
    from madrona_bots_tpu_torch import EnvConfig
    from madrona_bots_tpu_torch.ops import _build, raycast_cuda, row_gather_cuda, step_cuda

    _build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    cfg = EnvConfig(num_worlds=chip_smoke.W, init_agents=chip_smoke.INIT,
                    max_agents=chip_smoke.A)
    state = chip_smoke.stepped_state(
        cfg, dev, lambda heavy=False: chip_smoke.random_actions(gen, dev, heavy))
    sat_cfg, sat = chip_smoke.saturated_state(dev, gen)
    ray = (state.pos, state.heading, state.alive, state.species)
    ray_sat = (sat.pos, sat.heading, sat.alive, sat.species)
    kslot, fields, _, _ = chip_smoke.gather_inputs(state, cfg.num_species)
    torch.cuda.synchronize()

    times = {}
    step = lambda s: step_cuda.fused_step_systems(s, cfg)  # noqa: E731
    per_batch = chip_smoke.step_times(step, state)
    times["step_systems"] = {"ms": sorted(per_batch)[len(per_batch) // 2],
                             "batches_ms": per_batch,
                             **chip_smoke.step_costs(step, state, "")}
    entries = []
    if hasattr(step_cuda, "systems"):
        sys_inputs, _, _ = step_cuda.prepass(state.clone(), cfg)
        entries.append(("systems", lambda: step_cuda.systems(*sys_inputs, cfg)))
    entries += [("raycast", lambda: raycast_cuda.raycast(*ray, cfg)),
                ("raycast_saturated", lambda: raycast_cuda.raycast(*ray_sat, sat_cfg)),
                ("row_gather", lambda: row_gather_cuda.compact_fields(kslot, fields))]
    for name, fn in entries:
        per_batch = chip_smoke.batch_times(fn, 50)
        times[name] = {"ms": sorted(per_batch)[len(per_batch) // 2], "batches_ms": per_batch,
                       **chip_smoke.launch_costs(fn, name.split("_saturated")[0] + "_kernel")}
    print(json.dumps({"label": args.label, "package": os.path.dirname(
        madrona_bots_tpu_torch.__file__), "alive": int(state.alive.sum()),
        "rows_gathered": int((kslot >= 0).sum()), "kernels": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
