"""Interactive stdin test driver: the reference's only native test
(src/entry/test.cpp:4-88, built as `madrona_bots_test`). Counterpart of
`madrona_bots_tpu/tools/test_driver.py`.

One world, 16 agents. Each input line's characters set agent 0's action as
the reference maps them (test.cpp:41-66): w forward, s backward, r rotate
left, f rotate right, SPACE shoot, b breed; a line `q` quits. After each
step the 32 depth bytes of agent 0's sensor are printed (test.cpp:77-85).

Run: python -m madrona_bots_tpu_torch.tools.test_driver
(on CUDA; `--device cpu` runs the plain versions on the CPU).
"""

from __future__ import annotations

import argparse
import sys

from madrona_bots_tpu_torch.api.manager import SimManager


def agent0_row(mgr: SimManager) -> int:
    """The exported row of world 0's first alive agent."""
    return int(mgr.sensor_index_tensor().to_torch()[mgr.agent_offset_for_world(0), 0])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default CUDA (raises without a card)")
    args = p.parse_args(argv)
    mgr = SimManager(0, 1, 0, 16, device=args.device)
    print("madrona_bots_tpu_torch test driver: w/s/r/f/<space>/b + Enter to act, "
          "q to quit")
    for line in sys.stdin:
        line = line.rstrip("\n")
        if line == "q":
            break
        keys = set(line)
        mgr.set_action(agent0_row(mgr),
                       forward=int("w" in keys), backward=int("s" in keys),
                       rotate_left=int("r" in keys),
                       rotate_right=int("f" in keys),
                       shoot=int(" " in keys), breed=int("b" in keys))
        mgr.step()
        depth = mgr.depth_tensor(False).to_torch()[agent0_row(mgr)].tolist()
        print(" ".join(str(d) for d in depth), flush=True)
    print("bye")


if __name__ == "__main__":
    main()
