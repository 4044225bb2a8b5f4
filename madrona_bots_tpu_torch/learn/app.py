"""Viewer smoke driver: the reference's learn/app.py (app.py:1-20) opens the
viewer on 1 world / 16 agents and steps the simulator each frame.
Counterpart of `madrona_bots_tpu/learn/app.py`.

Run: python -m madrona_bots_tpu_torch.learn.app [--num_epochs N]
(on CUDA; `--device cpu` runs the plain versions on the CPU).
"""

from __future__ import annotations

import argparse

from madrona_bots_tpu_torch.device import resolve
from madrona_bots_tpu_torch.viz import ScriptBotsViewer


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num_worlds", type=int, default=1)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default CUDA (raises without a card)")
    args = p.parse_args(argv)

    viewer = ScriptBotsViewer(0, args.num_worlds, args.seed, 16,
                              device=resolve(args.device))
    sim_mgr = viewer.get_sim_mgr()

    def step_fn(epoch, carry):
        sim_mgr.step()

    viewer.loop(args.num_epochs, step_fn, None)


if __name__ == "__main__":
    main()
