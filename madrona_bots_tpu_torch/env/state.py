"""World state: struct-of-arrays with fixed-capacity agent slots.

Counterpart of `madrona_bots_tpu/env/state.py`: the same field names, shapes
and dtypes, as torch tensors in a dataclass. One exception: `world_keys`
holds each uint32 key word in an int64 tensor (torch's uint32 lacks the
shift and xor ops the counter RNG needs); `state_to_numpy` hands it back as
uint32, the layout of `jax.random.key_data`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.config import (EnvConfig, NUM_ACTIONS, SALT_INIT,
                                           SALT_WORLD)
from madrona_bots_tpu_torch.device import const, resolve


@dataclasses.dataclass
class WorldState:
    """All per-world state. Leading axis: worlds (W). A = max_agents."""

    pos: torch.Tensor            # [W, A, 2] f32
    heading: torch.Tensor        # [W, A]    f32
    health: torch.Tensor         # [W, A]    i32
    alive: torch.Tensor          # [W, A]    bool
    species: torch.Tensor        # [W, A]    i32, 1..NS (0 = empty slot)
    stats: torch.Tensor          # [W, A, 4] i32
    hidden: torch.Tensor         # [W, A, H] f32
    action: torch.Tensor         # [W, A, 6] i32
    surrounding: torch.Tensor    # [W, A, 2] f32
    reward: torch.Tensor         # [W, A]    f32

    sensor_depth: torch.Tensor          # [W, A, S] u8
    sensor_semantic: torch.Tensor       # [W, A, S] i8
    prev_sensor_depth: torch.Tensor     # [W, A, S] u8
    prev_sensor_semantic: torch.Tensor  # [W, A, S] i8
    finder: torch.Tensor                # [W, A]    i32, -1 = none

    prev_species: torch.Tensor      # [W, A]    i32
    prev_pos: torch.Tensor          # [W, A, 2] f32
    prev_health: torch.Tensor       # [W, A]    i32
    prev_surrounding: torch.Tensor  # [W, A, 2] f32
    prev_reward: torch.Tensor       # [W, A]    f32
    prev_action: torch.Tensor       # [W, A, 6] i32
    prev_stats: torch.Tensor        # [W, A, 4] i32
    prev_hidden: torch.Tensor       # [W, A, H] f32

    food_count: torch.Tensor     # [W, C, P]    i32
    food_cell: torch.Tensor      # [W, C, P, 2] i32
    num_food: torch.Tensor       # [W]          i32

    species_counts: torch.Tensor   # [W, NS] i32
    species_rewards: torch.Tensor  # [W, NS] f32

    step_count: torch.Tensor     # []     i32, stays on the device
    world_keys: torch.Tensor     # [W, 2] int64 holding uint32 words

    def replace(self, **changes) -> "WorldState":
        return dataclasses.replace(self, **changes)

    def clone(self) -> "WorldState":
        return WorldState(**{f.name: getattr(self, f.name).clone()
                             for f in dataclasses.fields(self)})

    @property
    def device(self) -> torch.device:
        return self.pos.device


FIELDS = tuple(f.name for f in dataclasses.fields(WorldState))


def init_state(cfg: EnvConfig, seed: int = 0, device=None,
               worlds: tuple[int, int] | None = None) -> WorldState:
    """initWorld semantics, bit-exact with the JAX `init_state(key(seed))`:
    init_agents agents in slots [0, init_agents) with species
    (slot % NS) + 1, uniform positions, heading 0, health 100; no food.

    `worlds=(lo, hi)` builds only global worlds [lo, hi) of the
    `cfg.num_worlds`: world keys are `fold_in(world_salted, global id)`, so
    the result equals that slice of the full state (a rank's shard)."""
    dev = resolve(device)
    lo, hi = (0, cfg.num_worlds) if worlds is None else worlds
    if not 0 <= lo < hi <= cfg.num_worlds:
        raise ValueError(f"world range [{lo}, {hi}) outside [0, {cfg.num_worlds})")
    W, A, S, H = hi - lo, cfg.max_agents, cfg.sensor_size, cfg.hidden_state_dim
    C, P, NS = cfg.num_chunks, cfg.max_food_packages, cfg.num_species
    f32, i32 = torch.float32, torch.int32

    world_salted = rng.fold_in(rng.key(seed, dev), SALT_WORLD)
    world_keys = rng.fold_in(world_salted[None, :],
                             torch.arange(lo, hi, device=dev))   # [W, 2]
    u = rng.uniform(rng.fold_in(world_keys, SALT_INIT), (A, 2))  # [W, A, 2]
    lims = const([cfg.world_lim_x, cfg.world_lim_y], f32, dev)
    pos = u * lims

    slot = torch.arange(A, dtype=i32, device=dev)
    alive = (slot < cfg.init_agents).expand(W, A).contiguous()
    species = torch.where(alive, slot % NS + 1, 0).to(i32)
    pos = torch.where(alive[..., None], pos, 0.0)
    health = torch.where(alive, cfg.init_health, 0).to(i32)

    def zeros(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return WorldState(
        pos=pos,
        heading=zeros(W, A),
        health=health,
        alive=alive,
        species=species,
        stats=zeros(W, A, 4, dtype=i32),
        hidden=zeros(W, A, H),
        action=zeros(W, A, NUM_ACTIONS, dtype=i32),
        surrounding=zeros(W, A, 2),
        reward=zeros(W, A),
        sensor_depth=zeros(W, A, S, dtype=torch.uint8),
        sensor_semantic=torch.full((W, A, S), -1, dtype=torch.int8, device=dev),
        prev_sensor_depth=zeros(W, A, S, dtype=torch.uint8),
        prev_sensor_semantic=torch.full((W, A, S), -1, dtype=torch.int8, device=dev),
        finder=torch.full((W, A), -1, dtype=i32, device=dev),
        prev_species=species.clone(),
        prev_pos=pos.clone(),
        prev_health=health.clone(),
        prev_surrounding=zeros(W, A, 2),
        prev_reward=zeros(W, A),
        prev_action=zeros(W, A, NUM_ACTIONS, dtype=i32),
        prev_stats=zeros(W, A, 4, dtype=i32),
        prev_hidden=zeros(W, A, H),
        food_count=zeros(W, C, P, dtype=i32),
        food_cell=zeros(W, C, P, 2, dtype=i32),
        num_food=zeros(W, dtype=i32),
        species_counts=zeros(W, NS, dtype=i32),
        species_rewards=zeros(W, NS),
        step_count=zeros(dtype=i32),
        world_keys=world_keys,
    )


def state_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> WorldState:
    """A state from numpy arrays under the JAX field names and dtypes (for
    example a JAX state with `world_keys` as `jax.random.key_data`)."""
    dev = resolve(device)
    out = {}
    for name in FIELDS:
        a = np.array(arrays[name], dtype=np.int64 if name == "world_keys" else None)
        out[name] = torch.from_numpy(a).to(dev)
    return WorldState(**out)


def state_to_numpy(state: WorldState) -> dict[str, np.ndarray]:
    """The state as numpy arrays with the JAX package's dtypes."""
    out = {name: getattr(state, name).cpu().numpy() for name in FIELDS}
    out["world_keys"] = out["world_keys"].astype(np.uint32)
    return out
