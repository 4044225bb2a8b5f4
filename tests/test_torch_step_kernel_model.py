"""A numpy model of the whole-step systems kernel (csrc/systems.cu), world
by world in the kernel's order, held bit-equal to the port's plain step
(`fused_step_systems(use_kernels=False)`) and to the jitted JAX
`step_systems` (every field exact, `surrounding` within rtol 1e-5 / atol
1e-4 against JAX, the D10 reassociation).

The model draws its random numbers with threefry2x32 in numpy uint32 as the
kernel does (one value a lane, no int64 tensors), places food in order,
builds the shot histogram slot by slot as the kernel's shared atomics do,
resolves eating per package with "lowest contender of a chunk wins", ranks
the births and respawns per slot class, and evaluates every float the way
the kernel does: each f32 product, sum and quotient its own rounding, one
correctly rounded fused multiply-add where the kernel calls __fmaf_rn, and
glibc sin/cos from one reduction (`trig.sincos`, as `sincosf_glibc`)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from madrona_bots_tpu import EnvConfig as JaxConfig
from madrona_bots_tpu import init_state as jax_init_state
from madrona_bots_tpu.config import RewardSetting as JaxReward
from madrona_bots_tpu_torch import rng as trng
from madrona_bots_tpu_torch import trig
from madrona_bots_tpu_torch.config import EnvConfig, RewardSetting
from madrona_bots_tpu_torch.env import env as tenv
from madrona_bots_tpu_torch.env.state import init_state, state_from_numpy, state_to_numpy
from madrona_bots_tpu_torch.ops import step_cuda
from test_torch_state import arrays_to_jax, assert_arrays_equal, jax_arrays
from test_torch_systems import _stacked_state, jax_step_systems, random_actions

F = np.float32
ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
FOOD_DRAWS = 10


# ---------------------------------------------------------------------------
# threefry2x32 in numpy uint32, as the kernel runs it
# ---------------------------------------------------------------------------

def threefry(key, x0, x1):
    """jax's threefry2x32 (20 rounds) on uint32 words; returns (y0, y1)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    x0, x1 = np.uint32(x0), np.uint32(x1)
    with np.errstate(over="ignore"):
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in ROT[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def fold_in(key, d):
    return threefry(key, 0, d)


def random_word(key, ctr):
    y0, y1 = threefry(key, 0, ctr)
    return int(y0 ^ y1)


def randint(key, ctr, lo, span):
    """Element `ctr` of jax's randint(key, shape, lo, lo + span)."""
    higher = random_word(threefry(key, 0, 0), ctr)
    lower = random_word(threefry(key, 0, 1), ctr)
    m = 65536 % span
    mult = ((m * m) & 0xFFFFFFFF) % span
    offset = ((higher % span) * mult + lower % span) & 0xFFFFFFFF
    return lo + offset % span


def food_gate(key, t):
    """The food-spawn gate of one world at step t (0 opens it)."""
    return randint(fold_in(fold_in(fold_in(key, t), 1), 0), 0, 0, 10)


def world_draws(key, t, cfg):
    """(the 10 food-spawn integers, respawn draws x and y [NS * FL]) of one
    world at step t: one value a lane in the kernel."""
    kt = fold_in(key, t)
    kf = fold_in(kt, 1)
    fv = []
    for i in range(FOOD_DRAWS):
        if i < 2:
            j, comp, lo, hi = i, 0, i, (10 if i == 0 else 3)
        else:
            j, comp, lo = 2 + (i - 2) // 4, (i - 2) % 4, 0
            hi = (cfg.num_chunks_x, cfg.num_chunks_y, cfg.chunk_width, cfg.chunk_width)[comp]
        fv.append(randint(fold_in(kf, j), comp, lo, 1 if hi <= lo else hi - lo))
    NS, FL = cfg.num_species, cfg.respawn_floor
    drawx, drawy = np.zeros(NS * FL, F), np.zeros(NS * FL, F)
    kr = fold_in(kt, 2)
    for s in range(NS):
        ks = fold_in(kr, s)
        for rest in range(2 * FL):
            bits = random_word(ks, rest)
            u = np.array((bits >> 9) | 0x3F800000, np.uint32).view(F) - F(1)
            if rest & 1:
                drawy[s * FL + rest // 2] = u * F(cfg.world_lim_y)
            else:
                drawx[s * FL + rest // 2] = u * F(cfg.world_lim_x)
    return fv, drawx, drawy


def fma_f32(a, b, c):
    """RN_f32(a * b + c): the product is exact in float64; a round-to-odd
    float64 sum rounds correctly to float32."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    bits = s.view(np.int64)
    step = np.where((e > 0) == (s > 0), 1, -1)
    return np.where((e != 0) & ((bits & 1) == 0), bits + step, bits).view(np.float64).astype(F)


# ---------------------------------------------------------------------------
# The kernel's order, one world at a time
# ---------------------------------------------------------------------------

def species_reward(count, hsum, cfg):
    cf = F(count)
    avg = F(hsum) / cf if count > 0 else F(0)
    return fma_f32(cf, F(1.0 / cfg.init_agents), avg * F(0.01)) - F(2)


def slot_reward(base, health, x, y, hf, he, ate, rep, cfg):
    def b(flag, v):
        return np.where(flag, F(v), F(0))

    pop = fma_f32(health.astype(F), F(0.01), base) - F(0.5)
    st = int(cfg.reward_setting)
    if st == 2:
        edge = ((x < F(4)) | (y < F(4)) | (x > F(cfg.world_lim_x - 4.0))
                | (y > F(cfg.world_lim_y - 4.0)))
        r = pop - b(edge, 1)
        r = (r + b(rep, 10)) - b(hf, 5)
        return (r + b(he, 15)) + b(ate, 7)
    if st == 3:
        return (b(rep, 10) + b(he, 15)) + b(ate, 7)
    if st == 4:
        return ((b(rep, 10) + b(he, 15)) - b(hf, 5)) + b(ate, 7)
    if st == 5:
        return pop
    if st == 6:
        return pop + b(ate, 10)
    if st == 7:
        return (pop + b(ate, 10)) + b(rep, 10)
    if st == 9:
        return (((pop + b(rep, 10)) - b(hf, 5)) + b(he, 15)) + b(ate, 7)
    return ((pop + b(ate, 10)) + b(rep, 10)) + b(he, 15)


def world_step(s, o, w, t, cfg, tally):
    """One world's step: reads the step-start arrays `s`, writes `o`."""
    A, NS, FL, P = cfg.max_agents, cfg.num_species, cfg.respawn_floor, cfg.max_food_packages
    C, cw, ncx, ncy = cfg.num_chunks, cfg.chunk_width, cfg.num_chunks_x, cfg.num_chunks_y
    cwf, cd = F(cw), F(cfg.cell_dim)
    slots = np.arange(A)
    cls = slots % NS

    # ---- 0. draws ----
    fv, drawx, drawy = world_draws(s["world_keys"][w], t, cfg)

    # ---- 1a. food spawn, attempt 1 after attempt 0 ----
    f_cnt = s["food_count"][w].reshape(C * P).copy()
    f_xy = s["food_cell"][w].reshape(C * P, 2).copy()
    nf = int(s["num_food"][w])
    n_eff = min(fv[1], max(cfg.total_allowed_food - nf, 0))
    if fv[0] == 0:
        tally["gate_open"] += 1
        tally["capped"] += int(n_eff < fv[1])
    for j in range(2):
        v = fv[2 + 4 * j: 6 + 4 * j]
        if fv[0] != 0 or j >= n_eff:
            continue
        c = v[0] + v[1] * ncx
        k = 0
        while k < P and f_cnt[c * P + k] > 0:
            k += 1
        if k == P:
            tally["full_chunk"] += 1
            continue
        f_cnt[c * P + k] = 1
        f_xy[c * P + k] = v[2], v[3]
        nf += 1
        tally["placed"] += 1
    f_cell = f_xy[:, 0] + cw * f_xy[:, 1]

    # ---- 1b. action system, one lane a slot ----
    alive0, species = s["alive"][w], s["species"][w]
    px, py, heading = s["pos"][w, :, 0], s["pos"][w, :, 1], s["heading"][w]
    finder, act = s["finder"][w], s["action"][w] > 0
    has = finder >= 0
    tgt = np.where(has, finder, 0)
    ta = has & alive0[tgt]
    ts = np.where(has, species[tgt], 0)
    ta_ok = np.ones(A, bool) if cfg.quirk_d1_stale_finder else ta
    valid_shot = act[:, 4] & alive0 & has & ta_ok
    shots = np.zeros(A, np.int64)
    for a in slots[valid_shot]:                      # the shared atomicAdd
        shots[tgt[a]] += 1
    tally["shots"] += int(valid_shot.sum())
    hit_f, hit_e = valid_shot & (ts == species), valid_shot & (ts != species)
    breed_ok = act[:, 5] & alive0 & has & ta_ok & (ts == species)

    nh, nx, ny = heading.copy(), px.copy(), py.copy()
    speedq, ci = np.zeros(A, np.int64), np.full(A, -1)
    al = alive0
    rl = act[:, 2]
    rr = act[:, 3] & ~rl
    delta = F(cfg.rotation_delta)
    nh[al] = ((heading + np.where(rl, delta, F(0))) - np.where(rr, delta, F(0)))[al]
    fwd = act[:, 0]
    bwd = act[:, 1] & ~fwd
    speed = F(cfg.move_speed)
    mv = np.where(fwd, speed, F(0)) - np.where(bwd, speed, F(0))
    cs, sn = (v.numpy() for v in trig.sincos(torch.from_numpy(nh[al])))
    x = px[al] + cs * mv[al]
    y = py[al] + sn * mv[al]
    x, y = np.where(x < F(0), F(0), x), np.where(y < F(0), F(0), y)
    x = np.where(x > F(cfg.world_lim_x - 1.0), F(cfg.world_lim_x - 1.0), x)
    y = np.where(y > F(cfg.world_lim_y - 1.0), F(cfg.world_lim_y - 1.0), y)
    nx[al], ny[al] = x, y
    dx, dy = x - px[al], y - py[al]
    speedq[al] = (np.sqrt(fma_f32(dy, dy, dx * dx)) * F(2)).astype(np.int32)
    chx, chy = (nx / cd) / cwf, (ny / cd) / cwf
    ci[al] = (np.clip(np.floor(chx).astype(np.int64), 0, ncx - 1)
              + np.clip(np.floor(chy).astype(np.int64), 0, ncy - 1) * ncx)[al]
    cell = ((cwf * (chx - np.floor(chx))).astype(np.int64)
            + cw * (cwf * (chy - np.floor(chy))).astype(np.int64))
    tally["headings"].append(nh[al])

    # ---- 2. the chain ----
    health0 = s["health"][w].astype(np.int64)
    health = np.where(alive0, health0 - cfg.shoot_damage * shots, health0)
    eaten = np.zeros(A, bool)
    cons = np.zeros(C * P, bool)
    for pk in range(P):
        contend = np.zeros(A, bool)
        winner = np.full(C, A)
        for a in slots:
            c = ci[a]
            if (alive0[a] and c >= 0 and not eaten[a] and f_cnt[c * P + pk] > 0
                    and cell[a] == f_cell[c * P + pk]):
                contend[a] = True
                winner[c] = min(winner[c], a)           # the shared atomicMin
        eaten |= contend & (winner[np.maximum(ci, 0)] == slots)
        cons[np.arange(C) * P + pk] = winner < A
    health = health + cfg.eat_health * eaten
    breeder = breed_ok & (health > cfg.breed_min_health)
    health = health - cfg.breed_cost * breeder
    alive_ad = alive0 & (health > 0)

    tal_n, tal_s = np.zeros(C, np.int64), np.zeros(C, np.int64)
    on = alive0 & (ci >= 0)
    np.add.at(tal_n, ci[on], 1)
    np.add.at(tal_s, ci[on], speedq[on])

    # birth claims: per-class inclusive scans
    free0 = ~alive0
    free_rank = np.zeros(A, np.int64)
    want_rank = np.zeros(A, np.int64)
    num_free, grant = np.zeros(NS, np.int64), np.zeros(NS, np.int64)
    for c in range(NS):
        idx = slots[c::NS]
        free_rank[idx] = np.cumsum(free0[idx]) - 1
        want_rank[idx] = np.cumsum(breeder[idx]) - 1
        num_free[c] = free0[idx].sum()
        grant[c] = min(breeder[idx].sum(), num_free[c])
    ptab_x, ptab_y = np.zeros(A, F), np.zeros(A, F)
    asub = A // NS
    parents = breeder & (want_rank < num_free[cls])
    ptab_x[cls[parents] * asub + want_rank[parents]] = nx[parents]
    ptab_y[cls[parents] * asub + want_rank[parents]] = ny[parents]
    born = free0 & (free_rank < grant[cls])
    bx = np.where(born, ptab_x[cls * asub + np.maximum(free_rank, 0)], F(0))
    by = np.where(born, ptab_y[cls * asub + np.maximum(free_rank, 0)], F(0))

    # the bilinear surrounding at the post-birth position
    alive_pb = alive_ad | born
    half = cwf * F(0.5)
    sx = ((np.where(born, bx, nx) / cd) - half) / cwf
    sy = ((np.where(born, by, ny) / cd) - half) / cwf
    fx, fy, gx, gy = np.floor(sx), np.floor(sy), np.ceil(sx), np.ceil(sy)
    xi, yi = sx - fx, sy - fy

    def corner(cxf, cyf, tab):
        cx, cy = cxf.astype(np.int64), cyf.astype(np.int64)
        ok = (cx >= 0) & (cy >= 0) & (cx < ncx) & (cy < ncy)
        return np.where(ok, tab[np.where(ok, cx + cy * ncx, 0)], 0).astype(F)

    def bilinear(tab):
        v = [corner(fx, fy, tab), corner(gx, fy, tab), corner(fx, gy, tab), corner(gx, gy, tab)]
        ox, oy = F(1) - xi, F(1) - yi
        n0 = xi * v[1] + ox * v[0]
        n1 = xi * v[3] + ox * v[2]
        return yi * n1 + oy * n0

    surrp = np.where(alive_pb, bilinear(tal_n), F(0))
    surrm = np.where(alive_pb, bilinear(tal_s), F(0))

    # species counts and health sums, post-birth and pre-respawn
    sp_pb = np.where(born, cls + 1, species)
    cnt, hs = np.zeros(NS, np.int64), np.zeros(NS, np.int64)
    counted = alive_pb & (sp_pb >= 1) & (sp_pb <= NS)
    np.add.at(cnt, sp_pb[counted] - 1, 1)
    np.add.at(hs, sp_pb[counted] - 1, np.where(born, cfg.child_health, health)[counted])

    # respawn: draw (class, rank among the free slots left after births)
    needed = np.maximum(FL - cnt[cls], 0)
    free2_rank = free_rank - grant[cls]
    resp = free0 & ~born & (free2_rank < needed)
    draw = cls * FL + np.where(resp, free2_rank, 0)
    tally["born"] += int(born.sum())
    tally["respawned"] += int(resp.sum())
    tally["eaten"] += int(eaten.sum())

    # ---- 3. post-pass ----
    fresh = born | resp
    alive1 = alive_ad | fresh
    dead = ~alive1
    h1 = np.where(resp, cfg.init_health, np.where(born, cfg.child_health, health))
    sp1 = np.where(fresh, cls + 1, species)
    x1 = np.where(resp, drawx[draw], np.where(born, bx, nx))
    y1 = np.where(resp, drawy[draw], np.where(born, by, ny))
    old = ~fresh
    st = np.stack([hit_f & old, hit_e & old, eaten & old, breeder & old], axis=-1)
    sp0 = np.clip(sp1 if cfg.quirk_d3_oob_reward else sp1 - 1, 0, NS - 1)
    rewards = np.array([species_reward(cnt[i], hs[i], cfg) for i in range(NS)], F)
    r = slot_reward(rewards[sp0], h1, x1, y1, st[:, 0], st[:, 1], st[:, 2], st[:, 3], cfg)
    keep_surr = alive_pb & ~(dead | resp)
    keep = alive1 & ~fresh
    clear = dead | fresh

    o["pos"][w] = np.where(dead[:, None], F(0), np.stack([x1, y1], axis=-1))
    o["heading"][w] = np.where(dead | fresh, F(0), nh)
    o["health"][w] = np.where(dead, 0, h1)
    o["alive"][w] = alive1
    o["species"][w] = np.where(dead, 0, sp1)
    o["stats"][w] = np.where(dead[:, None], 0, st)
    o["surrounding"][w] = np.where(keep_surr[:, None], np.stack([surrp, surrm], axis=-1), F(0))
    o["reward"][w] = np.where(dead, F(0), r)
    o["prev_sensor_depth"][w] = np.where(keep[:, None], s["sensor_depth"][w], 0)
    o["prev_sensor_semantic"][w] = np.where(keep[:, None], s["sensor_semantic"][w], -1)
    for name in ("hidden", "action", "prev_pos", "prev_surrounding", "prev_action",
                 "prev_stats", "prev_hidden", "prev_species", "prev_health", "prev_reward"):
        o[name][w][clear] = 0
    o["food_count"][w] = np.where(cons, 0, f_cnt).reshape(C, P)
    o["food_cell"][w] = f_xy.reshape(C, P, 2)
    o["num_food"][w] = nf - int(cons.sum())
    o["species_counts"][w] = cnt
    o["species_rewards"][w] = rewards


def kernel_model(arrays, cfg):
    """The whole systems step on numpy arrays (the JAX field layout), world
    by world. Returns (new arrays, tallies of what the step exercised)."""
    out = {k: np.array(v, copy=True) for k, v in arrays.items()}
    tally = dict(gate_open=0, capped=0, placed=0, full_chunk=0, shots=0, born=0,
                 respawned=0, eaten=0, headings=[])
    t = int(np.uint32(np.int64(arrays["step_count"]) & 0xFFFFFFFF))
    for w in range(cfg.num_worlds):
        world_step(arrays, out, w, t, cfg, tally)
    out["step_count"] = (arrays["step_count"] + 1).astype(np.int32)
    return out, tally


# ---------------------------------------------------------------------------
# The states
# ---------------------------------------------------------------------------

BASE = dict(num_worlds=8, init_agents=16, max_agents=32)


def stepped(kw, seed, steps=6):
    """(cfg, arrays): init_state(seed) after `steps` plain steps of heavy
    shoot/breed actions, with one more set of actions set."""
    cfg = EnvConfig(**kw)
    s = init_state(cfg, seed, device="cpu")
    r = np.random.default_rng(seed)
    for _ in range(steps):
        acts = random_actions(r, cfg.num_worlds, cfg.max_agents, heavy=True)
        s = tenv.step(tenv.set_actions(s, torch.from_numpy(acts)), cfg, use_kernels=False)
    tenv.set_actions(s, torch.from_numpy(random_actions(r, cfg.num_worlds, cfg.max_agents,
                                                        heavy=True)))
    return cfg, state_to_numpy(s)


def open_gates(arrays, cfg, want=3):
    """Set step_count to the first t >= 1000 at which at least `want`
    worlds open the food gate."""
    for t in range(1000, 3000):
        opened = sum(food_gate(k, t) == 0 for k in arrays["world_keys"])
        if opened >= want:
            arrays["step_count"] = np.array(t, np.int32)
            return
    raise AssertionError("no step opens enough gates")


def case_gate_open(seed):
    cfg, a = stepped(BASE, seed)
    open_gates(a, cfg)
    return cfg, a, ("gate_open", "placed")


def case_food_cap(seed):
    """num_food at the cap in even worlds and one below it in odd worlds."""
    cfg, a = stepped(BASE, seed)
    a["num_food"] = np.where(np.arange(cfg.num_worlds) % 2 == 0, cfg.total_allowed_food,
                             cfg.total_allowed_food - 1).astype(np.int32)
    open_gates(a, cfg)
    return cfg, a, ("gate_open", "capped")


def case_full_chunks(seed):
    """Every package of every chunk occupied, num_food low: the spawn finds
    no empty package. In each chunk the packages lie on the cell where an
    agent of the chunk stands after its move, so the eat stage resolves
    contention for stacked packages."""
    cfg, a = stepped(BASE, seed)
    a["food_count"][:] = 1
    a["num_food"][:] = 0
    open_gates(a, cfg)
    inputs, _, _ = step_cuda.prepass(state_from_numpy(a, device="cpu"), cfg)
    alive, cidx, cell = (inputs[i].numpy() for i in (0, 6, 7))
    for w, k in zip(*np.nonzero(alive)):
        a["food_cell"][w, cidx[w, k]] = cell[w, k] % cfg.chunk_width, cell[w, k] // cfg.chunk_width
    return cfg, a, ("gate_open", "full_chunk", "eaten")


def case_stepped(seed):
    cfg, a = stepped(BASE, seed)
    return cfg, a, ("born", "respawned")


def case_stacked(seed):
    kw = dict(num_worlds=2, init_agents=16, max_agents=32)
    a = jax_arrays(_stacked_state())
    r = np.random.default_rng(seed)
    a["action"] = random_actions(r, 2, 32, heavy=True)
    return EnvConfig(**kw), a, ("eaten",)


def case_saturated(seed):
    """Every slot alive at step start (finders from one sensor pass): no
    free slot for births or respawns."""
    cfg = EnvConfig(num_worlds=4, init_agents=32, max_agents=32)
    s = tenv.sensor_pass(init_state(cfg, seed, device="cpu"), cfg, use_kernels=False)
    r = np.random.default_rng(seed)
    tenv.set_actions(s, torch.from_numpy(random_actions(r, 4, 32, heavy=True)))
    return cfg, state_to_numpy(s), ("shots",)


def case_two_species(seed):
    cfg, a = stepped(dict(num_worlds=4, init_agents=12, max_agents=24, num_species=2), seed)
    return cfg, a, ("shots",)


CASES = {f"{name}_{seed}": (fn, seed)
         for name, fn, seeds in (("stepped", case_stepped, (0, 1, 2)),
                                 ("gate_open", case_gate_open, (0, 5)),
                                 ("food_cap", case_food_cap, (1,)),
                                 ("full_chunks", case_full_chunks, (2,)),
                                 ("stacked", case_stacked, (3, 4)),
                                 ("saturated", case_saturated, (5,)),
                                 ("two_species", case_two_species, (6, 7)))
         for seed in seeds}


def config_case(seed, **over):
    cfg, a = stepped({**BASE, **over}, seed)
    return cfg, a, ()


for _setting in RewardSetting:
    CASES[f"reward_{_setting.name}"] = (
        lambda seed, st=_setting: config_case(seed, reward_setting=st), 10 + int(_setting))
CASES["quirk_d1"] = (lambda seed: config_case(seed, quirk_d1_stale_finder=True), 21)
CASES["quirk_d3"] = (lambda seed: config_case(seed, quirk_d3_oob_reward=True), 22)


def jax_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["reward_setting"] = JaxReward(int(cfg.reward_setting))
    return JaxConfig(**kw)


def three_ways(cfg, arrays):
    """(the model's arrays and tallies, the plain step's, the JAX step's)."""
    got, tally = kernel_model(arrays, cfg)
    plain = state_to_numpy(step_cuda.fused_step_systems(
        state_from_numpy(arrays, device="cpu"), cfg, use_kernels=False))
    jcfg = jax_config(cfg)
    like = jax_init_state(jax.random.key(0), jcfg)
    want = jax_arrays(jax_step_systems(arrays_to_jax(arrays, like), jcfg))
    return got, tally, plain, want


@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_plain_and_jax(name):
    fn, seed = CASES[name]
    cfg, arrays, exercised = fn(seed)
    got, tally, plain, want = three_ways(cfg, arrays)
    assert_arrays_equal(plain, got, f"{name} model vs plain")
    assert_arrays_equal(want, got, f"{name} model vs jax", ("surrounding", "prev_surrounding"))
    for what in exercised:
        assert tally[what] > 0, (name, what, tally)
    if name.startswith("saturated"):
        assert tally["born"] == 0 and tally["respawned"] == 0
        assert bool(arrays["alive"].all())


@pytest.mark.parametrize("seed", [8, 9])
def test_model_three_steps_match_plain(seed):
    """Three steps in a row, each followed by the plain sensor pass and new
    actions: the model's step count, draws and food carry over as the plain
    step's do."""
    cfg, arrays = stepped(BASE, seed)
    s = state_from_numpy(arrays, device="cpu")
    r = np.random.default_rng(seed)
    for t in range(3):
        got, _ = kernel_model(arrays, cfg)
        s = step_cuda.fused_step_systems(s, cfg, use_kernels=False)
        assert_arrays_equal(state_to_numpy(s), got, f"step {t}")
        acts = torch.from_numpy(random_actions(r, cfg.num_worlds, cfg.max_agents, heavy=True))
        s = tenv.set_actions(tenv.sensor_pass(s, cfg, use_kernels=False), acts)
        arrays = state_to_numpy(tenv.set_actions(tenv.sensor_pass(
            state_from_numpy(got, device="cpu"), cfg, use_kernels=False), acts))


@pytest.mark.parametrize("seed", [0, 1])
def test_sincos_matches_cos_and_sin_on_model_headings(seed):
    """The kernel takes both from one glibc reduction (`sincosf_glibc`);
    the plain action system calls trig.cos and trig.sin."""
    cfg, arrays = stepped(BASE, seed)
    arrays["heading"] = (arrays["heading"] + np.float32(37.0) * seed).astype(np.float32)
    _, tally = kernel_model(arrays, cfg)
    h = torch.from_numpy(np.concatenate(tally["headings"]))
    assert h.numel() > 0
    c, s = trig.sincos(h)
    assert torch.equal(c.view(torch.int32), trig.cos(h).view(torch.int32))
    assert torch.equal(s.view(torch.int32), trig.sin(h).view(torch.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_model_rng_matches_port_rng(seed):
    """The model's uint32 threefry, fold_in, randint and uniform words equal
    rng.py's int64 versions (which equal jax.random's)."""
    r = np.random.default_rng(seed)
    words = r.integers(0, 2 ** 32, (6, 2), dtype=np.uint64)
    for k0, k1 in words:
        key = torch.tensor([int(k0), int(k1)], dtype=torch.int64)
        d = int(r.integers(0, 2 ** 32))
        want = trng.fold_in(key, d)
        assert tuple(int(v) for v in fold_in((k0, k1), d)) == tuple(want.tolist())
        span = int(r.integers(1, 200))
        want_int = trng.randint(key, (4,), 3, 3 + span)
        assert [randint((k0, k1), c, 3, span) for c in range(4)] == want_int.tolist()
        bits = trng.random_bits(key, (5,))
        assert [random_word((k0, k1), c) for c in range(5)] == bits.tolist()

