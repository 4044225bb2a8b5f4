"""The systems step: the Step graph minus the sensor pass.

Counterpart of `madrona_bots_tpu/ops/step_pallas.py::fused_step_systems`.
On a CUDA state, `step_systems_cuda` runs all of it in one launch of
`csrc/systems.cu`, in place on the state: food spawn and respawn draws
(threefry in the kernel), the action system, the per-world chain that needs
cross-agent feedback (eat, breed, death, tallies, birth claims, surrounding,
species counts, respawn) and the post-pass (health chain, rewards, stats,
food map, prev rows, canonicalised dead slots).

Its plain version is `step_systems_plain`: the torch pre-pass (`prepass`),
the chain in torch (`systems_reference`, from env/systems.py) and the torch
post-pass. It runs on CPU states, and wherever `use_kernels` is False. The
chain works on unpacked food ([W, C, P] count and cell id cell_x +
chunk_width * cell_y); the TPU kernel's 10-bit packings, byte-packed lane
cumsums, rank waves and `grant_ub` trip count exist only for TPU lanes.
"""

from __future__ import annotations

import array
import ctypes
import functools
import operator
from typing import Callable, NamedTuple

import torch

from madrona_bots_tpu_torch.config import NUM_ACTIONS, EnvConfig
from madrona_bots_tpu_torch.env import systems as sy
from madrona_bots_tpu_torch.env.state import FIELDS
from madrona_bots_tpu_torch.ops import _build
from madrona_bots_tpu_torch.utils import profiling

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


def step_systems_plain(state, cfg: EnvConfig):
    """The whole-step kernel's plain version: the torch pre-pass, the chain
    (`systems_reference`) and the torch post-pass. Bit-identical to the
    jitted JAX `step_systems` on every field except `surrounding` (rtol
    1e-5). Consumes `state` like the JAX step, which donates it: the fields
    that pass through with dead or fresh slots cleared (hidden, action, the
    prev twins) are cleared in place instead of copied."""
    t = state.step_count
    alive0 = state.alive
    A = alive0.shape[1]
    NS = cfg.num_species
    inputs, act, (food_count, food_cell, num_food) = prepass(state, cfg)
    k = systems_reference(*inputs, cfg)

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


def fused_step_systems(state, cfg: EnvConfig, use_kernels: bool = True):
    """The Step graph minus the sensor pass. Consumes `state`. With
    `use_kernels` the state's device decides: one kernel launch on a CUDA
    state, the plain version on a CPU state."""
    return (step_systems_cuda if use_kernels else step_systems_plain)(state, cfg)


# ---------------------------------------------------------------------------
# The whole-step kernel's wrapper
# ---------------------------------------------------------------------------

launches = 0
"""Launches of the systems kernel since the count was last set to 0."""


class _Params(ctypes.Structure):
    """`Params` of csrc/systems.cu, field for field."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "A", "H", "S", "ncx", "ncy", "cw", "P", "NS", "FL", "total_food",
        "shoot_damage", "eat_health", "breed_min_health", "breed_cost",
        "child_health", "init_health", "reward_setting", "d1", "d3")]
        + [(n, ctypes.c_float) for n in (
            "cell_dim", "rotation_delta", "move_speed", "lim_x", "lim_y",
            "clamp_x", "clamp_y", "edge_x", "edge_y", "recip_init", "recip100")])


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=f32))


class _Setup(NamedTuple):
    params: _Params            # held here so that params_addr stays valid
    params_addr: int
    get_fields: Callable       # state -> its fields in `WorldState` order
    specs: tuple               # ((dtype, shape), ...) in the same order


@functools.lru_cache(maxsize=None)
def _setup(cfg: EnvConfig, W: int) -> _Setup:
    """The kernel's `Params` for cfg and the state's field specs, made once
    per (cfg, W)."""
    A, S, H = cfg.max_agents, cfg.sensor_size, cfg.hidden_state_dim
    C, P, NS = cfg.num_chunks, cfg.max_food_packages, cfg.num_species
    prm = _Params(
        A, H, S, cfg.num_chunks_x, cfg.num_chunks_y, cfg.chunk_width, P, NS,
        cfg.respawn_floor, cfg.total_allowed_food, cfg.shoot_damage, cfg.eat_health,
        cfg.breed_min_health, cfg.breed_cost, cfg.child_health, cfg.init_health,
        int(cfg.reward_setting), int(cfg.quirk_d1_stale_finder),
        int(cfg.quirk_d3_oob_reward),
        cfg.cell_dim, cfg.rotation_delta, cfg.move_speed, cfg.world_lim_x,
        cfg.world_lim_y, cfg.world_lim_x - 1.0, cfg.world_lim_y - 1.0,
        cfg.world_lim_x - 4.0, cfg.world_lim_y - 4.0,
        _f32(1.0 / cfg.init_agents), _f32(1.0 / 100.0))
    u8, i8, i64 = torch.uint8, torch.int8, torch.int64
    specs = dict(
        pos=((W, A, 2), f32), heading=((W, A), f32), health=((W, A), i32),
        alive=((W, A), torch.bool), species=((W, A), i32), stats=((W, A, 4), i32),
        hidden=((W, A, H), f32), action=((W, A, NUM_ACTIONS), i32),
        surrounding=((W, A, 2), f32), reward=((W, A), f32),
        sensor_depth=((W, A, S), u8), sensor_semantic=((W, A, S), i8),
        prev_sensor_depth=((W, A, S), u8), prev_sensor_semantic=((W, A, S), i8),
        finder=((W, A), i32), prev_species=((W, A), i32), prev_pos=((W, A, 2), f32),
        prev_health=((W, A), i32), prev_surrounding=((W, A, 2), f32),
        prev_reward=((W, A), f32), prev_action=((W, A, NUM_ACTIONS), i32),
        prev_stats=((W, A, 4), i32), prev_hidden=((W, A, H), f32),
        food_count=((W, C, P), i32), food_cell=((W, C, P, 2), i32), num_food=((W,), i32),
        species_counts=((W, NS), i32), species_rewards=((W, NS), f32),
        step_count=((), i32), world_keys=((W, 2), i64))
    return _Setup(prm, ctypes.addressof(prm), operator.attrgetter(*FIELDS),
                  tuple((specs[n][1], torch.Size(specs[n][0])) for n in FIELDS))


def _bad_field(i: int, t: torch.Tensor, spec, what: str) -> ValueError:
    return ValueError(f"systems kernel: {FIELDS[i]} must be a {what}{spec[0]} tensor of "
                      f"shape {tuple(spec[1])}, got {t.dtype} {tuple(t.shape)} on {t.device}")


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def step_systems_cuda(state, cfg: EnvConfig):
    """The whole systems step in one launch of `csrc/systems.cu` on a CUDA
    state, written in place into it. Returns `state` itself, with a new
    `step_count` tensor (every block of the launch reads the old one). A
    CPU state takes `step_systems_plain`. Every field must have its dtype
    and shape; the kernel also needs them contiguous on the state's card.
    The call is the span `mbots.env.systems`."""
    global launches
    with profiling.span("mbots.env.systems"):
        W = state.alive.shape[0]
        setup = _setup(cfg, W)
        fields = setup.get_fields(state)
        if state.alive.device.type == "cpu":
            for i, (t, spec) in enumerate(zip(fields, setup.specs)):
                if t.dtype is not spec[0] or t.shape != spec[1]:
                    raise _bad_field(i, t, spec, "")
            return step_systems_plain(state, cfg)
        dev = state.alive.get_device()
        if dev < 0:
            raise ValueError(f"systems kernel: state on {state.alive.device}")
        if cfg.max_agents > 1024:
            raise ValueError(f"systems kernel: needs max_agents <= 1024, got {cfg.max_agents}")
        for i, (t, spec) in enumerate(zip(fields, setup.specs)):
            if (t.dtype is not spec[0] or t.shape != spec[1] or not t.is_contiguous()
                    or t.get_device() != dev):
                raise _bad_field(i, t, spec, f"contiguous cuda:{dev} ")
        step_next = torch.empty((), dtype=i32, device=state.alive.device)
        ptrs = array.array("Q", [t.data_ptr() for t in fields])
        ptrs.append(step_next.data_ptr())
        fn = _build.function("systems", "mbots_step_systems", _ARGS)
        # The raw handle of the current stream (torch.cuda.current_stream(dev)
        # .cuda_stream without building a Stream object on every step).
        err = fn(ptrs.buffer_info()[0], setup.params_addr, W,
                 torch._C._cuda_getCurrentRawStream(dev))
        if err != 0:
            raise RuntimeError(f"systems kernel launch failed: CUDA error {err}")
        launches += 1
        state.step_count = step_next
        return state
