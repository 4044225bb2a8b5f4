"""Step composition: the Step graph (systems) followed by the Sensor graph.

Counterpart of `madrona_bots_tpu/env/env.py`. PyTorch runs eagerly, so
`step` is a plain call and `rollout` a Python loop. `use_kernels` (the JAX
`use_pallas`) picks the Hopper kernels; on CPU tensors their wrappers run
the plain versions, so the default does the right thing on either device.

The JAX path sorts worlds by population before the sensor kernel to fill
TPU lanes; the outputs are the same without it, and the port does not sort.
"""

from __future__ import annotations

import torch

from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.env import raycast as raycast_plain
from madrona_bots_tpu_torch.env.state import WorldState
from madrona_bots_tpu_torch.ops import raycast_cuda
from madrona_bots_tpu_torch.ops.step_cuda import fused_step_systems


def step_systems(state: WorldState, cfg: EnvConfig,
                 use_kernels: bool = True) -> WorldState:
    """The Step graph minus the sensor pass. Consumes `state`."""
    return fused_step_systems(state, cfg, use_kernels)


def sensor_pass(state: WorldState, cfg: EnvConfig,
                use_kernels: bool = True) -> WorldState:
    """The Sensor graph: raycast depth / semantic and the crosshair finder."""
    run = raycast_cuda.raycast if use_kernels else raycast_plain.raycast
    depth, semantic, finder = run(state.pos, state.heading, state.alive,
                                  state.species, cfg)
    return state.replace(sensor_depth=depth, sensor_semantic=semantic,
                         finder=finder)


def step(state: WorldState, cfg: EnvConfig, use_kernels: bool = True) -> WorldState:
    """One full tick: Step graph then Sensor graph. Consumes `state`, as
    the JAX step donates it."""
    return sensor_pass(step_systems(state, cfg, use_kernels), cfg, use_kernels)


def shift_observations(state: WorldState, cfg: EnvConfig | None = None) -> WorldState:
    """The ShiftObservations graph: current -> prev for the 7 observation
    components and the hidden state, copied in place into the prev buffers
    (the JAX version donates the state). With cfg.quirk_d4_shift_typo,
    prev.hitEnemy receives cur.hitFriendly, as in the reference."""
    for name in ("species", "pos", "health", "surrounding", "reward", "action",
                 "stats", "hidden"):
        getattr(state, "prev_" + name).copy_(getattr(state, name))
    if cfg is not None and cfg.quirk_d4_shift_typo:
        state.prev_stats[..., 1].copy_(state.stats[..., 0])
    return state


def set_actions(state: WorldState, actions: torch.Tensor) -> WorldState:
    """Write the action buffer in place. actions: [W, A, 6], slot-aligned."""
    state.action.copy_(actions)
    return state


def rollout(state: WorldState, num_steps: int, policy_fn, cfg: EnvConfig,
            use_kernels: bool = True) -> WorldState:
    """`num_steps` full ticks with actions from `policy_fn(state) ->
    [W, A, 6]`; returns the final state."""
    for _ in range(num_steps):
        state = step(set_actions(state, policy_fn(state)), cfg, use_kernels)
    return state
