"""The per-step simulation systems over [num_worlds, max_agents], in plain
PyTorch.

Counterpart of `madrona_bots_tpu/env/systems.py`. The JAX module writes
every indexed read and write as a one-hot contraction, because dynamic
gathers are slow on a TPU; here they are `gather` / `scatter` calls, with the
same results: integer payloads, "lowest slot wins" and the class-partitioned
slot claims (SPEC D2b). The functions take the interface of the systems
kernel's stages (`ops/step_cuda.py` composes them into `systems_reference`,
the kernel's plain version), so a stage here and its block in
`csrc/systems.cu` compute the same thing on the same inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from madrona_bots_tpu_torch import rng, trig
from madrona_bots_tpu_torch.config import (
    ACTION_BACKWARD, ACTION_BREED, ACTION_FORWARD, ACTION_ROTATE_LEFT,
    ACTION_ROTATE_RIGHT, ACTION_SHOOT, SALT_FOOD, SALT_RESPAWN, EnvConfig)
from madrona_bots_tpu_torch.device import const, full

i32 = torch.int32
f32 = torch.float32


# ---------------------------------------------------------------------------
# Slot allocator and geometry helpers
# ---------------------------------------------------------------------------

def claim_slots(free_mask: torch.Tensor, active: torch.Tensor):
    """The r-th active claimant (ascending v) receives the r-th free slot
    (ascending a). free_mask [W, A], active [W, V] bool. Returns
    slot_for_v [W, V] i32, -1 where no slot was granted."""
    W, A = free_mask.shape
    free_rank = torch.cumsum(free_mask.to(i32), dim=1) - 1
    num_free = free_mask.sum(dim=1, keepdim=True)
    slot_of_rank = torch.zeros((W, A + 1), dtype=torch.int64, device=free_mask.device)
    slot_of_rank.scatter_(1, torch.where(free_mask, free_rank, A).long(),
                          torch.arange(A, device=free_mask.device).expand(W, A))
    want_rank = torch.cumsum(active.to(i32), dim=1) - 1
    granted = active & (want_rank < num_free)
    slot = torch.gather(slot_of_rank, 1, want_rank.clamp(min=0).long())
    return torch.where(granted, slot, -1).to(i32)


def chunk_index(pos: torch.Tensor, cfg: EnvConfig) -> torch.Tensor:
    """Linear chunk index of a world position (always valid post-clamp)."""
    cell = pos / full(cfg.cell_dim, pos)
    ch = torch.floor(cell / full(float(cfg.chunk_width), pos)).to(i32)
    cx = ch[..., 0].clamp(0, cfg.num_chunks_x - 1)
    cy = ch[..., 1].clamp(0, cfg.num_chunks_y - 1)
    return cx + cy * cfg.num_chunks_x


def cell_in_chunk(pos: torch.Tensor, cfg: EnvConfig) -> torch.Tensor:
    """Cell (x, y) within the chunk: chunk_width * frac(pos / cell_dim /
    chunk_width), truncated."""
    cw = full(float(cfg.chunk_width), pos)
    chcoord = pos / full(cfg.cell_dim, pos) / cw
    frac = chcoord - torch.floor(chcoord)
    return (cw * frac).to(i32)


# ---------------------------------------------------------------------------
# Food spawn (addFoodSystem)
# ---------------------------------------------------------------------------

def food_spawn(food_count, food_cell, num_food, world_keys, t, cfg: EnvConfig):
    """Per world: a 10% gate, then 1-2 spawn attempts into the first empty
    package slot of a random chunk; attempt 1 sees attempt 0's placement."""
    W = world_keys.shape[0]
    C, P = cfg.num_chunks, cfg.max_food_packages
    dev = world_keys.device
    k = rng.fold_in(rng.fold_in(world_keys, t), SALT_FOOD)
    gate = rng.randint(rng.fold_in(k, 0), (), 0, 10)
    n = rng.randint(rng.fold_in(k, 1), (), 1, 3)
    hi = const([cfg.num_chunks_x, cfg.num_chunks_y, cfg.chunk_width,
                cfg.chunk_width], torch.int64, dev)
    per = [rng.randint(rng.fold_in(k, 2 + j), (4,), 0, hi) for j in range(2)]
    n_eff = torch.minimum(n, (cfg.total_allowed_food - num_food).clamp(min=0))
    gate_ok = gate == 0

    chunk_ids = torch.arange(C, device=dev)
    pkg_ids = torch.arange(P, device=dev)
    for j in range(2):
        active = gate_ok & (j < n_eff)
        c = (per[j][:, 0] + per[j][:, 1] * cfg.num_chunks_x).long()     # [W]
        occupied = torch.gather(food_count, 1,
                                c[:, None, None].expand(W, 1, P))[:, 0] > 0
        first_empty = torch.argmin(occupied.to(i32), dim=1)             # first False
        place = active & ~occupied.all(dim=1)
        sel = ((chunk_ids[None, :] == c[:, None])[:, :, None]
               & (pkg_ids[None, :] == first_empty[:, None])[:, None, :]
               & place[:, None, None])                                  # [W, C, P]
        food_count = torch.where(sel, 1, food_count)
        food_cell = torch.where(sel[..., None], per[j][:, None, None, 2:4], food_cell)
        num_food = num_food + place.to(i32)
    return food_count, food_cell, num_food


# ---------------------------------------------------------------------------
# Action system: shoot via last frame's finder, rotate, move
# ---------------------------------------------------------------------------

class ActionOut(NamedTuple):
    pos: torch.Tensor           # [W, A, 2] after the move and clamp
    heading: torch.Tensor       # [W, A]
    shots: torch.Tensor         # [W, A] i32, valid shots landing on each slot
    hit_friendly: torch.Tensor  # [W, A] bool (shooter stat)
    hit_enemy: torch.Tensor     # [W, A] bool
    speed_q: torch.Tensor       # [W, A] i32 quantised move length
    cidx: torch.Tensor          # [W, A] i32 chunk at the new position, -1 dead


def crosshair_target(alive, species, finder):
    """(alive, species) of the slot in each agent's crosshair at step start;
    (False, 0) where the finder is -1."""
    has = finder >= 0
    idx = finder.clamp(min=0).long()
    ta = has & torch.gather(alive, 1, idx)
    ts = torch.where(has, torch.gather(species, 1, idx), 0)
    return ta, ts


def action_system(pos, heading, alive, species, action, finder,
                  cfg: EnvConfig) -> ActionOut:
    W, A = alive.shape
    act = action > 0

    # Shoot: quirk D1 drops the target-alive check (stale handle).
    ta, ts = crosshair_target(alive, species, finder)
    ta_ok = True if cfg.quirk_d1_stale_finder else ta
    valid_shot = act[..., ACTION_SHOOT] & alive & (finder >= 0) & ta_ok
    shots = torch.zeros((W, A), dtype=i32, device=alive.device)
    shots.scatter_add_(1, finder.clamp(min=0).long(), valid_shot.to(i32))
    same = ts == species
    hit_friendly = valid_shot & same
    hit_enemy = valid_shot & ~same

    # Rotate (if / elif).
    rl = act[..., ACTION_ROTATE_LEFT]
    rr = act[..., ACTION_ROTATE_RIGHT] & ~rl
    delta = full(cfg.rotation_delta, heading)
    zero = full(0.0, heading)
    new_heading = torch.where(
        alive, heading + torch.where(rl, delta, zero) - torch.where(rr, delta, zero),
        heading)

    # Move (if / elif) and clamp.
    fwd = act[..., ACTION_FORWARD]
    bwd = act[..., ACTION_BACKWARD] & ~fwd
    speed = full(cfg.move_speed, heading)
    mv = torch.where(fwd, speed, zero) - torch.where(bwd, speed, zero)
    direction = torch.stack([trig.cos(new_heading), trig.sin(new_heading)], dim=-1)
    new_pos = pos + direction * (mv * alive)[..., None]
    lim = const([cfg.world_lim_x - 1.0, cfg.world_lim_y - 1.0], f32, pos.device)
    new_pos = torch.minimum(torch.clamp(new_pos, min=0.0), lim)
    new_pos = torch.where(alive[..., None], new_pos, pos)

    # Quantised speed for the chunk tallies: XLA:CPU evaluates
    # sum(d * d) as fma(dy, dy, dx * dx), so the port does too.
    d = new_pos - pos
    dx, dy = d[..., 0], d[..., 1]
    delta_len = torch.sqrt(trig.fma_f32(dy, dy, dx * dx))
    speed_q = (delta_len * 2.0).to(i32)
    cidx = torch.where(alive, chunk_index(new_pos, cfg), -1)
    return ActionOut(new_pos, new_heading, shots, hit_friendly, hit_enemy,
                     speed_q, cidx)


def breed_eligible(alive, species, action, finder, cfg: EnvConfig):
    """The step-start part of breeding: breed action, alive, a crosshair
    target of the same species that is alive (quirk D1 drops the liveness
    check; a dead slot holds species 0 and still fails the species test).
    The post-eat health test is the kernel's."""
    ta, ts = crosshair_target(alive, species, finder)
    ta_ok = True if cfg.quirk_d1_stale_finder else ta
    return ((action[..., ACTION_BREED] > 0) & alive & (finder >= 0) & ta_ok
            & (ts == species))


# ---------------------------------------------------------------------------
# Health sync: damage, eat, breed, death, birth
# ---------------------------------------------------------------------------

class HealthOut(NamedTuple):
    health: torch.Tensor      # [W, A] i32 after damage, eating and breeding
    alive: torch.Tensor       # [W, A] bool after death, before births
    eaten: torch.Tensor       # [W, A] bool
    breeder: torch.Tensor     # [W, A] bool
    consumed: torch.Tensor    # [W, C, P] bool, packages eaten this step
    born: torch.Tensor        # [W, A] bool, slots that hold a newborn
    bposx: torch.Tensor       # [W, A] f32 newborn position (parent's), else 0
    bposy: torch.Tensor


def eat(alive, cidx, cell, food_count, food_cell_id, cfg: EnvConfig):
    """Packages in order; for each, the lowest alive slot standing on the
    package's cell that has not eaten yet eats it. cell / food_cell_id are
    cell_x + chunk_width * cell_y. Returns (eaten [W, A], consumed [W, C, P])."""
    W, A = alive.shape
    C = cfg.num_chunks
    slot = torch.arange(A, dtype=i32, device=alive.device).expand(W, A)
    cl = cidx.clamp(min=0).long()
    eaten = torch.zeros_like(alive)
    consumed = []
    for p in range(cfg.max_food_packages):
        has = torch.gather(food_count[:, :, p] > 0, 1, cl)
        pkg_cell = torch.gather(food_cell_id[:, :, p], 1, cl)
        contend = alive & (cidx >= 0) & has & ~eaten & (cell == pkg_cell)
        winner = torch.full((W, C), A, dtype=i32, device=alive.device)
        winner.scatter_reduce_(1, cl, torch.where(contend, slot, A), "amin")
        is_winner = contend & (torch.gather(winner, 1, cl) == slot)
        eaten = eaten | is_winner
        consumed.append(winner < A)
    return eaten, torch.stack(consumed, dim=2)


def health_sync(alive, health, shots, cidx, cell, food_count, food_cell_id,
                breed_ok, posx, posy, cfg: EnvConfig) -> HealthOut:
    W, A = alive.shape
    NS = cfg.num_species
    health = torch.where(alive, health - cfg.shoot_damage * shots, health)
    eaten, consumed = eat(alive, cidx, cell, food_count, food_cell_id, cfg)
    health = health + cfg.eat_health * eaten.to(i32)
    breeder = breed_ok & (health > cfg.breed_min_health)
    health = health - cfg.breed_cost * breeder.to(i32)
    alive_ad = alive & (health > 0)

    # Births claim slots free at step start (this step's deaths are not
    # reusable), within the parent's slot class (D2b): [W, A/NS, NS] views.
    free3 = (~alive).reshape(W, A // NS, NS)
    breeder3 = breeder.reshape(W, A // NS, NS)
    px3, py3 = posx.reshape(W, A // NS, NS), posy.reshape(W, A // NS, NS)
    born = torch.zeros_like(free3)
    bx = torch.zeros_like(px3)
    by = torch.zeros_like(py3)
    for c in range(NS):
        slot_c = claim_slots(free3[:, :, c], breeder3[:, :, c])
        born[:, :, c] = scatter_from_claims(born[:, :, c], slot_c, True)
        bx[:, :, c] = scatter_from_claims(bx[:, :, c], slot_c, px3[:, :, c])
        by[:, :, c] = scatter_from_claims(by[:, :, c], slot_c, py3[:, :, c])
    return HealthOut(health, alive_ad, eaten, breeder, consumed,
                     born.reshape(W, A), bx.reshape(W, A), by.reshape(W, A))


def scatter_from_claims(dst, slot_for_v, values):
    """dst[w, slot_for_v[w, v]] = values[w, v] for granted claims."""
    W, V = slot_for_v.shape
    A = dst.shape[1]
    if isinstance(values, torch.Tensor):
        vals = values.to(dst.dtype)
    else:
        vals = torch.full((W, V), values, dtype=dst.dtype, device=dst.device)
    out = torch.cat([dst, dst.new_zeros((W, 1))], dim=1)
    out.scatter_(1, torch.where(slot_for_v >= 0, slot_for_v, A).long(), vals)
    return out[:, :A]


# ---------------------------------------------------------------------------
# Chunk tallies and the surrounding observation
# ---------------------------------------------------------------------------

def chunk_tallies(alive, cidx, speed_q, cfg: EnvConfig):
    """Alive agents and their summed quantised speed per chunk, at the
    post-move positions and step-start liveness. [W, C] i32 each."""
    W = alive.shape[0]
    cl = cidx.clamp(min=0).long()
    agents = torch.zeros((W, cfg.num_chunks), dtype=i32, device=alive.device)
    agents.scatter_add_(1, cl, alive.to(i32))
    movement = torch.zeros_like(agents)
    movement.scatter_add_(1, cl, torch.where(alive, speed_q, 0))
    return agents, movement


def surrounding_observation(posx, posy, alive, chunk_agents, chunk_speed,
                            cfg: EnvConfig):
    """Bilinear interpolation of the chunk tallies at the agent position,
    in the oracle's 4-corner form (`oracle.py::_bilinear`, the form of the
    JAX systems kernel): x first, then y, each product its own f32 op.
    Returns (presence, movement) [W, A] f32, 0 for dead slots. The JAX spec
    path sums the corner weights first; the two agree within rtol 1e-5."""
    cw = full(float(cfg.chunk_width), posx)
    half = full(cfg.chunk_width * 0.5, posx)
    cd = full(cfg.cell_dim, posx)
    chx = (posx / cd - half) / cw
    chy = (posy / cd - half) / cw
    fx, fy = torch.floor(chx), torch.floor(chy)
    cx_, cy_ = torch.ceil(chx), torch.ceil(chy)
    xi = chx - fx
    yi = chy - fy

    def corner(cxf, cyf):
        cx, cy = cxf.to(i32), cyf.to(i32)
        ok = (cx >= 0) & (cy >= 0) & (cx < cfg.num_chunks_x) & (cy < cfg.num_chunks_y)
        lin = torch.where(ok, cx + cy * cfg.num_chunks_x, 0).long()
        n = torch.where(ok, torch.gather(chunk_agents, 1, lin), 0).to(f32)
        s = torch.where(ok, torch.gather(chunk_speed, 1, lin), 0).to(f32)
        return n, s

    (n0, s0), (n1, s1), (n2, s2), (n3, s3) = (
        corner(fx, fy), corner(cx_, fy), corner(fx, cy_), corner(cx_, cy_))
    one = full(1.0, posx)

    def bilinear(v0, v1, v2, v3):
        x0 = xi * v1 + (one - xi) * v0
        x1 = xi * v3 + (one - xi) * v2
        return yi * x1 + (one - yi) * x0

    presence = torch.where(alive, bilinear(n0, n1, n2, n3), 0.0)
    movement = torch.where(alive, bilinear(s0, s1, s2, s3), 0.0)
    return presence, movement


# ---------------------------------------------------------------------------
# Species info: counts, health sums, respawn
# ---------------------------------------------------------------------------

def respawn_draws(world_keys, t, cfg: EnvConfig) -> torch.Tensor:
    """Respawn position draws, [W, NS, respawn_floor, 2] f32."""
    base = rng.fold_in(rng.fold_in(world_keys, t), SALT_RESPAWN)
    lims = const([cfg.world_lim_x, cfg.world_lim_y], f32, world_keys.device)
    return torch.stack([rng.uniform(rng.fold_in(base, s), (cfg.respawn_floor, 2)) * lims
                        for s in range(cfg.num_species)], dim=1)


class SpeciesOut(NamedTuple):
    counts: torch.Tensor      # [W, NS] i32, post-birth, pre-respawn
    hsum: torch.Tensor        # [W, NS] i32 summed health of those agents
    respawned: torch.Tensor   # [W, A] bool
    rposx: torch.Tensor       # [W, A] f32 respawn position, else 0
    rposy: torch.Tensor


def species_info(alive, species, health, free, drawx, drawy,
                 cfg: EnvConfig) -> SpeciesOut:
    """Per-species counts and health sums, then the respawn top-up: class s
    claims its free slots (ascending) for respawn_floor - count[s] agents,
    the r-th taking draw (s, r). drawx/drawy: [W, NS * respawn_floor]."""
    W, A = alive.shape
    NS, FL = cfg.num_species, cfg.respawn_floor
    onehot = ((species - 1)[..., None] == torch.arange(NS, device=alive.device)) \
        & alive[..., None]                                           # [W, A, NS]
    counts = onehot.sum(dim=1).to(i32)
    hsum = torch.where(onehot, health[..., None], 0).sum(dim=1).to(i32)
    needed = (FL - counts).clamp(min=0)                              # [W, NS]

    free3 = free.reshape(W, A // NS, NS)
    rsp = torch.zeros_like(free3)
    rx = torch.zeros((W, A // NS, NS), dtype=f32, device=alive.device)
    ry = torch.zeros_like(rx)
    ranks = torch.arange(FL, device=alive.device)
    for s in range(NS):
        slot_s = claim_slots(free3[:, :, s], ranks[None, :] < needed[:, s:s + 1])
        rsp[:, :, s] = scatter_from_claims(rsp[:, :, s], slot_s, True)
        rx[:, :, s] = scatter_from_claims(rx[:, :, s], slot_s, drawx[:, s * FL:(s + 1) * FL])
        ry[:, :, s] = scatter_from_claims(ry[:, :, s], slot_s, drawy[:, s * FL:(s + 1) * FL])
    return SpeciesOut(counts, hsum, rsp.reshape(W, A), rx.reshape(W, A),
                      ry.reshape(W, A))


def _recip(d: float, like: torch.Tensor) -> torch.Tensor:
    """f32(1 / d). XLA:CPU rewrites `x / d` for a constant d as
    `x * f32(1 / d)` (and may fuse that product into an add); the port
    evaluates the same forms so that rewards match the JAX package's bits."""
    return full(float(torch.tensor(1.0 / d, dtype=f32)), like)


def species_rewards(counts, hsum, cfg: EnvConfig):
    """Per-species reward: count / init_agents + mean health / 100 - 2."""
    cf = counts.to(f32)
    avg_health = torch.where(counts > 0, hsum.to(f32) / cf, 0.0)
    return trig.fma_f32(cf, _recip(cfg.init_agents, cf),
                        avg_health * _recip(100.0, cf)) - 2.0


# ---------------------------------------------------------------------------
# Reward: all 8 settings, default SETTING_8
# ---------------------------------------------------------------------------

def reward_system(species, health, alive, species_rewards_, stats, pos,
                  cfg: EnvConfig):
    """Per-agent reward from this step's event flags `stats` [W, A, 4].
    Reads rewards[species - 1] (deviation D3; quirk_d3 reads
    rewards[min(species, NS - 1)] as the reference's out-of-bounds read)."""
    setting = int(cfg.reward_setting)
    NS = cfg.num_species
    sp0 = (species if cfg.quirk_d3_oob_reward else species - 1).clamp(0, NS - 1)
    base = torch.gather(species_rewards_, 1, sp0.long())
    pop_health = trig.fma_f32(health.to(f32), _recip(100.0, base), base) - 0.5

    hit_friendly = stats[..., 0] > 0
    hit_enemy = stats[..., 1] > 0
    ate = stats[..., 2] > 0
    repro = stats[..., 3] > 0

    def bonus(flag, v):
        return torch.where(flag, full(v, base), full(0.0, base))

    if setting == 2:
        pr = 4.0
        at_edge = ((pos[..., 0] < pr) | (pos[..., 1] < pr)
                   | (pos[..., 0] > cfg.world_lim_x - pr)
                   | (pos[..., 1] > cfg.world_lim_y - pr))
        r = pop_health - bonus(at_edge, 1.0)
        r = r + bonus(repro, 10.0) - bonus(hit_friendly, 5.0)
        r = r + bonus(hit_enemy, 15.0) + bonus(ate, 7.0)
    elif setting == 3:
        r = bonus(repro, 10.0) + bonus(hit_enemy, 15.0) + bonus(ate, 7.0)
    elif setting == 4:
        r = (bonus(repro, 10.0) + bonus(hit_enemy, 15.0)
             - bonus(hit_friendly, 5.0) + bonus(ate, 7.0))
    elif setting == 5:
        r = pop_health
    elif setting == 6:
        r = pop_health + bonus(ate, 10.0)
    elif setting == 7:
        r = pop_health + bonus(ate, 10.0) + bonus(repro, 10.0)
    elif setting == 9:  # SETTING_7B, the trailing block
        r = (pop_health + bonus(repro, 10.0) - bonus(hit_friendly, 5.0)
             + bonus(hit_enemy, 15.0) + bonus(ate, 7.0))
    else:  # SETTING_8, the active one
        r = (pop_health + bonus(ate, 10.0) + bonus(repro, 10.0)
             + bonus(hit_enemy, 15.0))
    return torch.where(alive, r, 0.0)
