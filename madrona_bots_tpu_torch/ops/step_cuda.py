"""The systems step: PyTorch pre-pass, the systems kernel, PyTorch post-pass.

Counterpart of `madrona_bots_tpu/ops/step_pallas.py::fused_step_systems`.
The pre-pass (food spawn, rotate / move / clamp, the finder-dependent
step-start quantities, respawn draws) and the post-pass (health chain,
rewards, stats, food map, canonicalised dead slots) are elementwise torch
code. In the middle, `systems` runs the per-world chain that needs
cross-agent feedback: the CUDA kernel `csrc/systems.cu` on a CUDA tensor,
its plain version `systems_reference` on a CPU tensor.

The kernel takes its inputs unpacked: food as [W, C, P] count and cell id
(cell_x + chunk_width * cell_y), `consumed` back as [W, C, P]. The TPU
kernel's 10-bit packings, byte-packed lane cumsums, rank waves and the
`grant_ub` trip count exist only for TPU lanes and are gone.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.env import systems as sy
from madrona_bots_tpu_torch.ops import _build

i32 = torch.int32
f32 = torch.float32


class SystemsOut(NamedTuple):
    eaten: torch.Tensor       # [W, A] bool
    breeder: torch.Tensor     # [W, A] bool
    born: torch.Tensor        # [W, A] bool
    bposx: torch.Tensor       # [W, A] f32
    bposy: torch.Tensor       # [W, A] f32
    respawned: torch.Tensor   # [W, A] bool
    rposx: torch.Tensor       # [W, A] f32
    rposy: torch.Tensor       # [W, A] f32
    surrp: torch.Tensor       # [W, A] f32
    surrm: torch.Tensor       # [W, A] f32
    counts: torch.Tensor      # [W, NS] i32
    hsum: torch.Tensor        # [W, NS] i32
    consumed: torch.Tensor    # [W, C, P] bool


def systems_reference(alive0, species, health, posx, posy, speedq, cidx, cell,
                      food_count, food_cell_id, drawx, drawy, dmg, breed_ok,
                      cfg: EnvConfig) -> SystemsOut:
    """The systems kernel's plain version, composed from env/systems.py:
    eat, breed, death, chunk tallies, class-partitioned birth claims, the
    bilinear surrounding at post-birth positions, species counts and health
    sums, respawn top-up. Same inputs and outputs as the kernel."""
    NS = cfg.num_species
    W, A = alive0.shape
    h = sy.health_sync(alive0, health, dmg, cidx, cell, food_count, food_cell_id,
                       breed_ok, posx, posy, cfg)
    agents, movement = sy.chunk_tallies(alive0, cidx, speedq, cfg)
    alive_pb = h.alive | h.born
    pfx = torch.where(h.born, h.bposx, posx)
    pfy = torch.where(h.born, h.bposy, posy)
    surrp, surrm = sy.surrounding_observation(pfx, pfy, alive_pb, agents, movement, cfg)
    cls1 = torch.arange(A, dtype=i32, device=alive0.device) % NS + 1
    sp = sy.species_info(alive_pb, torch.where(h.born, cls1, species),
                         torch.where(h.born, cfg.child_health, h.health),
                         ~alive0 & ~h.born, drawx, drawy, cfg)
    return SystemsOut(h.eaten, h.breeder, h.born, h.bposx, h.bposy,
                      sp.respawned, sp.rposx, sp.rposy, surrp, surrm,
                      sp.counts, sp.hsum, h.consumed)


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

launches = 0
"""Launches of the systems kernel since the count was last set to 0."""

_ARGS = ([ctypes.c_void_p] * 14          # inputs
         + [ctypes.c_void_p] * 13        # outputs
         + [ctypes.c_int] * 13           # W, A, shape and rule constants
         + [ctypes.c_float]              # cell_dim
         + [ctypes.c_void_p])            # stream


def check_inputs(kernel: str, specs) -> None:
    """Raise unless every (name, tensor, shape, dtype) matches and all the
    tensors are contiguous and on one device."""
    dev = specs[0][1].device
    for name, t, shape, dtype in specs:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{kernel} kernel: {name} must be a contiguous "
                             f"{dtype} tensor of shape {tuple(shape)} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def systems(alive0, species, health, posx, posy, speedq, cidx, cell,
            food_count, food_cell_id, drawx, drawy, dmg, breed_ok,
            cfg: EnvConfig) -> SystemsOut:
    """Run the systems kernel on CUDA tensors; CPU tensors take
    `systems_reference`. Either way the inputs must have the kernel's
    shapes, dtypes and layout."""
    global launches
    W, A = alive0.shape
    C, P, NS, FL = (cfg.num_chunks, cfg.max_food_packages, cfg.num_species,
                    cfg.respawn_floor)
    if A > 1024 or A % NS:
        raise ValueError(f"systems kernel: needs max_agents <= 1024 and a "
                         f"multiple of num_species, got {A}")
    ins = [("alive0", alive0, (W, A), torch.bool), ("species", species, (W, A), i32),
           ("health", health, (W, A), i32), ("posx", posx, (W, A), f32),
           ("posy", posy, (W, A), f32), ("speedq", speedq, (W, A), i32),
           ("cidx", cidx, (W, A), i32), ("cell", cell, (W, A), i32),
           ("food_count", food_count, (W, C, P), i32),
           ("food_cell_id", food_cell_id, (W, C, P), i32),
           ("drawx", drawx, (W, NS * FL), f32), ("drawy", drawy, (W, NS * FL), f32),
           ("dmg", dmg, (W, A), i32), ("breed_ok", breed_ok, (W, A), torch.bool)]
    check_inputs("systems", ins)
    if alive0.device.type == "cpu":
        return systems_reference(*(t for _, t, _, _ in ins), cfg)
    if alive0.device.type != "cuda":
        raise ValueError(f"systems kernel: tensors on {alive0.device}")

    def new(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=alive0.device)

    out = SystemsOut(
        new((W, A), torch.bool), new((W, A), torch.bool), new((W, A), torch.bool),
        new((W, A), f32), new((W, A), f32), new((W, A), torch.bool),
        new((W, A), f32), new((W, A), f32), new((W, A), f32), new((W, A), f32),
        new((W, NS), i32), new((W, NS), i32), new((W, C, P), torch.bool))
    fn = _build.function("systems", "mbots_systems", _ARGS)
    err = fn(*[t.data_ptr() for _, t, _, _ in ins], *[t.data_ptr() for t in out],
             W, A, cfg.num_chunks_x, cfg.num_chunks_y, cfg.chunk_width, P, NS, FL,
             cfg.shoot_damage, cfg.eat_health, cfg.breed_min_health,
             cfg.breed_cost, cfg.child_health, cfg.cell_dim,
             torch.cuda.current_stream(alive0.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"systems kernel launch failed: CUDA error {err}")
    launches += 1
    return out


# ---------------------------------------------------------------------------
# The fused step
# ---------------------------------------------------------------------------

def prepass(state, cfg: EnvConfig):
    """Food spawn, rotate / move / clamp and the step-start quantities.
    Returns (the systems kernel's inputs as a tuple, the action system's
    outputs, the food state after spawning)."""
    t = state.step_count
    W = state.alive.shape[0]
    NS, FL, cw = cfg.num_species, cfg.respawn_floor, cfg.chunk_width
    food = sy.food_spawn(state.food_count, state.food_cell, state.num_food,
                         state.world_keys, t, cfg)
    act = sy.action_system(state.pos, state.heading, state.alive, state.species,
                           state.action, state.finder, cfg)
    breed_ok = sy.breed_eligible(state.alive, state.species, state.action,
                                 state.finder, cfg)
    cell2 = sy.cell_in_chunk(act.pos, cfg)
    cell = cell2[..., 0] + cw * cell2[..., 1]
    food_cell_id = food[1][..., 0] + cw * food[1][..., 1]
    draws = sy.respawn_draws(state.world_keys, t, cfg)           # [W, NS, FL, 2]
    inputs = (state.alive, state.species, state.health,
              act.pos[..., 0].contiguous(), act.pos[..., 1].contiguous(),
              act.speed_q, act.cidx, cell, food[0], food_cell_id,
              draws[..., 0].reshape(W, NS * FL).contiguous(),
              draws[..., 1].reshape(W, NS * FL).contiguous(),
              act.shots, breed_ok)
    return inputs, act, food


def fused_step_systems(state, cfg: EnvConfig, use_kernels: bool = True):
    """The Step graph minus the sensor pass, bit-identical to the JAX
    `step_systems` on every field except `surrounding` (rtol 1e-5).

    Consumes `state` like the JAX step, which donates it: the fields that
    pass through with dead or fresh slots cleared (hidden, action, the prev
    twins) are cleared in place instead of copied."""
    t = state.step_count
    alive0 = state.alive
    A = alive0.shape[1]
    NS = cfg.num_species
    inputs, act, (food_count, food_cell, num_food) = prepass(state, cfg)
    k = (systems if use_kernels else systems_reference)(*inputs, cfg)

    # ---- post-pass: health chain, same integer ops as the kernel ran ----
    born, respawned = k.born, k.respawned
    health = torch.where(alive0, state.health - cfg.shoot_damage * act.shots,
                         state.health)
    health = health + cfg.eat_health * k.eaten.to(i32)
    health = health - cfg.breed_cost * k.breeder.to(i32)
    alive_ad = alive0 & (health > 0)
    alive = alive_ad | born | respawned
    new_mask = born | respawned

    health = torch.where(born, cfg.child_health, health)
    health = torch.where(respawned, cfg.init_health, health).to(i32)
    cls1 = torch.arange(A, dtype=i32, device=alive0.device) % NS + 1
    species = torch.where(new_mask, cls1, state.species)
    heading = torch.where(new_mask, 0.0, act.heading)
    pos = torch.where(born[..., None], torch.stack([k.bposx, k.bposy], dim=-1), act.pos)
    pos = torch.where(respawned[..., None], torch.stack([k.rposx, k.rposy], dim=-1), pos)

    rewards = sy.species_rewards(k.counts, k.hsum, cfg)
    surrounding = torch.where((alive_ad | born)[..., None],
                              torch.stack([k.surrp, k.surrm], dim=-1), 0.0)

    old = ~new_mask
    stats = torch.stack([act.hit_friendly & old, act.hit_enemy & old,
                         k.eaten & old, k.breeder & old], dim=-1).to(i32)
    reward = sy.reward_system(species, health, alive, rewards, stats, pos, cfg)

    food_count = torch.where(k.consumed, 0, food_count)
    num_food = num_food - k.consumed.sum(dim=(1, 2), dtype=i32)

    keep = (alive & ~new_mask)[..., None]
    prev_sensor_depth = torch.where(keep, state.sensor_depth, 0).to(torch.uint8)
    prev_sensor_semantic = torch.where(keep, state.sensor_semantic, -1).to(torch.int8)

    dead = ~alive
    clear = (dead | new_mask)
    clear3 = clear[..., None]
    for name in ("hidden", "action", "prev_pos", "prev_surrounding",
                 "prev_action", "prev_stats", "prev_hidden"):
        getattr(state, name).masked_fill_(clear3, 0)
    for name in ("prev_species", "prev_health", "prev_reward"):
        getattr(state, name).masked_fill_(clear, 0)
    return state.replace(
        pos=torch.where(dead[..., None], 0.0, pos),
        heading=torch.where(dead, 0.0, heading),
        health=torch.where(dead, 0, health),
        alive=alive,
        species=torch.where(dead, 0, species),
        stats=torch.where(dead[..., None], 0, stats),
        surrounding=torch.where((dead | respawned)[..., None], 0.0, surrounding),
        reward=torch.where(dead, 0.0, reward),
        prev_sensor_depth=prev_sensor_depth,
        prev_sensor_semantic=prev_sensor_semantic,
        food_count=food_count,
        food_cell=food_cell,
        num_food=num_food,
        species_counts=k.counts,
        species_rewards=rewards,
        step_count=t + 1,
    )
