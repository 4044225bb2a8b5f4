"""Hot-path profiler: the environment step's phases, ms a step on the card.

Usage:  python -m madrona_bots_tpu_torch.tools.prof [worlds] [max_agents] [warm]

Counterpart of `madrona_bots_tpu/tools/prof.py`, with the same three lines:
the systems step on the plain path, the systems step on the kernel
(`csrc/systems.cu`), and the full step (systems and raycast kernels). After
`warm` steps on the kernel path from `init_state`, each line runs K = 32
steps on a clone of the warmed state with random one-hot actions (four
action tensors drawn beforehand, cycled) and reads their time from CUDA
events. Runs only on CUDA.
"""

from __future__ import annotations

import sys

import torch

from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.config import NUM_ACTIONS, EnvConfig
from madrona_bots_tpu_torch.device import resolve
from madrona_bots_tpu_torch.env import env as env_mod
from madrona_bots_tpu_torch.env.state import init_state

K = 32


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    W = int(argv[0]) if len(argv) > 0 else 8192
    A = int(argv[1]) if len(argv) > 1 else 128
    warm = int(argv[2]) if len(argv) > 2 else 64
    dev = resolve("cuda")
    cfg = EnvConfig(num_worlds=W, init_agents=32, max_agents=A)
    actions = [torch.nn.functional.one_hot(
        rng.randint(rng.fold_in(rng.key(9, dev), i), (W, A), 0, NUM_ACTIONS).long(),
        NUM_ACTIONS).to(torch.int32) for i in range(4)]

    state = init_state(cfg, 0, dev)
    for i in range(warm):
        state = env_mod.step(env_mod.set_actions(state, actions[i % 4]), cfg)
    torch.cuda.synchronize(dev)
    print(f"after {warm} warm steps: alive {int(state.alive.sum())}", flush=True)

    def time_steps(name, body):
        st = state.clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for i in range(K):
            st = body(env_mod.set_actions(st, actions[i % 4]))
        end.record()
        torch.cuda.synchronize(dev)
        ms = start.elapsed_time(end) / K
        print(f"{name:38s} {ms:8.3f} ms/step   ({W * 1000.0 / ms:,.0f} env-steps/s)",
              flush=True)
        return ms

    return {
        "systems_plain": time_steps("systems (plain PyTorch path)",
                                    lambda s: env_mod.step_systems(s, cfg, False)),
        "systems_kernel": time_steps("systems (CUDA kernel)",
                                     lambda s: env_mod.step_systems(s, cfg, True)),
        "full_step": time_steps("full step (systems + raycast kernels)",
                                lambda s: env_mod.step(s, cfg, True)),
    }


if __name__ == "__main__":
    main()
