"""Drive the PyTorch port's world rollout on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
  1. build both kernels from madrona_bots_tpu_torch/csrc (nvcc, in parallel);
  2. the systems kernel against its plain version on the same inputs, at
     8192 worlds x 128 slots after 16 plain steps of heavy shoot/breed;
  3. the raycast kernel against its plain version on those states and on a
     saturated one (128 agents per world);
  4. the main path: init_state, 64 timed ticks of set_actions -> step ->
     shift_observations, construct_obs; each kernel must launch once a tick;
     16 ticks on the kernel and the plain path must agree;
  5. reference checks on small inputs: the kernel path on the card against
     the plain path on the CPU, and the 50-step digests of
     tests/golden_trajectory.json (recorded from the JAX package);
  6. each kernel's time per launch, its plain version's time and its bound.

Prints a `kernels` JSON line, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Exits non-zero without a CUDA
device or without the package beside it. Timings use CUDA events.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12             # H100 SXM FP32 outside the tensor cores
SURR_RTOL, SURR_ATOL = 1e-5, 1e-4
W, A, INIT = 8192, 128, 32
TICKS = 64
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    """A phase check: raise (and so end the run without a result line)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from madrona_bots_tpu_torch import EnvConfig, init_state, step
    from madrona_bots_tpu_torch.env import env as env_mod
    from madrona_bots_tpu_torch.env import raycast as raycast_plain
    from madrona_bots_tpu_torch.env.state import FIELDS, state_to_numpy
    from madrona_bots_tpu_torch.learn.obs import construct_obs
    from madrona_bots_tpu_torch.ops import _build, raycast_cuda, step_cuda

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build ----
    secs, ptxas = _build.build(verbose=True)
    log(f"[build] both kernels in {secs:.1f} s")
    for line in ptxas.splitlines():
        if "registers" in line or line.startswith("["):
            log("  " + line.strip())

    cfg = EnvConfig(num_worlds=W, init_agents=INIT, max_agents=A)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def one_hot_actions(heavy: bool = False) -> torch.Tensor:
        a = torch.nn.functional.one_hot(
            torch.randint(0, 6, (W, A), generator=gen, device=dev), 6).to(torch.int32)
        if heavy:
            a[..., 4] |= torch.randint(0, 2, (W, A), generator=gen, device=dev,
                                       dtype=torch.int32)
            a[..., 5] |= torch.randint(0, 2, (W, A), generator=gen, device=dev,
                                       dtype=torch.int32)
        return a

    # ---- 2. systems kernel against its plain version ----
    t0 = time.perf_counter()
    state = init_state(cfg, seed=7, device=dev)
    for _ in range(16):
        state = step(env_mod.set_actions(state, one_hot_actions(heavy=True)), cfg,
                     use_kernels=False)
    env_mod.set_actions(state, one_hot_actions(heavy=True))
    torch.cuda.synchronize()
    log(f"[systems] 16 plain steps in {time.perf_counter() - t0:.1f} s; "
        f"alive {int(state.alive.sum())} of {W * A}")
    sys_inputs, _, _ = step_cuda.prepass(state, cfg)
    # A second input set with food in every package slot: random cells in
    # odd worlds; in even worlds all packages of a chunk stacked on the cell
    # of an agent standing in it, so the eat stage resolves contention.
    C, P, cw = cfg.num_chunks, cfg.max_food_packages, cfg.chunk_width
    alive0, cidx, cell = sys_inputs[0], sys_inputs[6], sys_inputs[7]
    fcell = torch.randint(0, cw * cw, (W, C, P), generator=gen, device=dev,
                          dtype=torch.int32)
    agent_cell = torch.full((W, C + 1), -1, dtype=torch.int32, device=dev)
    agent_cell.scatter_(1, torch.where(alive0, cidx, C).long(), cell)
    agent_cell = agent_cell[:, :C, None].expand(W, C, P)
    even = (torch.arange(W, device=dev) % 2 == 0)[:, None, None]
    fcell = torch.where(even & (agent_cell >= 0), agent_cell, fcell).contiguous()
    dense = (sys_inputs[:8] + (torch.ones_like(sys_inputs[8]), fcell)
             + sys_inputs[10:])
    for label, inputs in (("after_16_steps", sys_inputs), ("dense_food", dense)):
        got = step_cuda.systems(*inputs, cfg)
        want = step_cuda.systems_reference(*inputs, cfg)
        torch.cuda.synchronize()
        mism = {}
        for name, g, w in zip(got._fields, got, want):
            if name in ("surrp", "surrm"):
                ok = torch.isclose(g, w, rtol=SURR_RTOL, atol=SURR_ATOL)
                mism[name] = int((~ok).sum())
                mism[name + "_bits"] = int((g != w).sum())
            else:
                mism[name] = int((g != w).sum())
        log(f"[systems] {label}: kernel vs plain mismatches {json.dumps(mism)}")
        log(f"[systems] {label}: births {int(got.born.sum())}, respawns "
            f"{int(got.respawned.sum())}, eaten {int(got.eaten.sum())}, "
            f"breeders {int(got.breeder.sum())}, packages consumed "
            f"{int(got.consumed.sum())}")
        check(all(v == 0 for k, v in mism.items() if not k.endswith("_bits")),
              f"systems {label}: {mism}")
        check(int(got.born.sum()) > 0 and int(got.respawned.sum()) > 0,
              f"systems {label}: no births or respawns")
    check(int(got.eaten.sum()) > 0, "systems dense_food: nothing eaten")
    got = step_cuda.systems(*sys_inputs, cfg)

    # ---- 3. raycast kernel against its plain version ----
    sat_cfg = EnvConfig(num_worlds=W, init_agents=A, max_agents=A)
    sat = init_state(sat_cfg, seed=3, device=dev)
    sat.heading.copy_(torch.rand((W, A), generator=gen, device=dev) * 6.28)
    ray_cases = {"after_16_steps": (state, cfg), "saturated": (sat, sat_cfg)}
    ray_err = 0.0
    for label, (s, c) in ray_cases.items():
        args = (s.pos, s.heading, s.alive, s.species)
        got_r = raycast_cuda.raycast(*args, c)
        want_r = raycast_plain.raycast(*args, c)
        torch.cuda.synchronize()
        m = {n: int((g != w).sum()) for n, g, w in
             zip(("depth", "semantic", "finder"), got_r, want_r)}
        log(f"[raycast] {label} (alive {int(s.alive.sum())}): kernel vs plain "
            f"mismatches {json.dumps(m)}")
        check(all(v == 0 for v in m.values()), f"raycast {label}: {m}")
        ray_err = max([ray_err] + [float((g.float() - w.float()).abs().max())
                                   for g, w in zip(got_r, want_r)])
    ray_inputs = (state.pos, state.heading, state.alive, state.species)
    sat_inputs = (sat.pos, sat.heading, sat.alive, sat.species, sat_cfg)
    del sat, ray_cases

    # ---- 4. the main path ----
    main = init_state(cfg, seed=0, device=dev)
    for _ in range(8):                                   # warm-up
        main = env_mod.shift_observations(
            step(env_mod.set_actions(main, one_hot_actions()), cfg), cfg)
    torch.cuda.synchronize()
    step_cuda.launches = 0
    raycast_cuda.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host0 = time.perf_counter()
    start.record()
    for _ in range(TICKS):
        main = env_mod.shift_observations(
            step(env_mod.set_actions(main, one_hot_actions()), cfg), cfg)
    obs = construct_obs(main, cfg)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - host0
    launches = {"systems": step_cuda.launches, "raycast": raycast_cuda.launches}
    ms_tick = start.elapsed_time(end) / TICKS
    log(f"[main] {TICKS} ticks at {W}x{A} (init {INIT}): {ms_tick:.3f} ms/tick, "
        f"{W * 1000.0 / ms_tick:.1f} env-steps/s (CUDA events; host clock "
        f"{host_s * 1000.0 / TICKS:.3f} ms/tick) on {smi}")
    log(f"[main] launches {json.dumps(launches)}")
    check(launches == {"systems": TICKS, "raycast": TICKS}, f"launches {launches}")
    check(obs.shape == (W, A, cfg.obs_dim) and bool(torch.isfinite(obs).all()),
          f"obs {tuple(obs.shape)} not finite or misshapen")
    pop = int(main.alive.sum())
    log(f"[main] obs {tuple(obs.shape)} finite; alive {pop}")
    check(0 < pop <= W * A, f"population {pop}")

    k_state, p_state = main.clone(), main.clone()
    for t in range(16):
        acts = one_hot_actions(heavy=(t % 2 == 0))
        k_state = env_mod.shift_observations(
            step(env_mod.set_actions(k_state, acts), cfg, use_kernels=True), cfg)
        p_state = env_mod.shift_observations(
            step(env_mod.set_actions(p_state, acts), cfg, use_kernels=False), cfg)
    diff = {f: int((getattr(k_state, f) != getattr(p_state, f)).sum())
            for f in FIELDS if f not in ("surrounding", "prev_surrounding")}
    surr_bad = sum(int((~torch.isclose(getattr(k_state, f), getattr(p_state, f),
                                       rtol=SURR_RTOL, atol=SURR_ATOL)).sum())
                   for f in ("surrounding", "prev_surrounding"))
    log(f"[main] 16 ticks kernels vs plain: {sum(diff.values())} exact-field "
        f"mismatches, {surr_bad} surrounding outside tolerance")
    check(sum(diff.values()) == 0 and surr_bad == 0, f"kernel vs plain ticks: {diff}")
    del k_state, p_state, main, obs

    # ---- 5. reference checks on small inputs ----
    small = EnvConfig(num_worlds=4, init_agents=32, max_agents=64)
    rng = np.random.default_rng(11)
    sg, sc = init_state(small, 11, dev), init_state(small, 11, "cpu")
    for t in range(30):
        a = np.zeros((4, 64, 6), np.int32)
        a[np.arange(4)[:, None], np.arange(64)[None, :], rng.integers(0, 6, (4, 64))] = 1
        a[:, :, 4] |= rng.integers(0, 2, (4, 64)).astype(np.int32)
        a[:, :, 5] |= rng.integers(0, 2, (4, 64)).astype(np.int32)
        sg = step(env_mod.set_actions(sg, torch.from_numpy(a).to(dev)), small)
        sc = step(env_mod.set_actions(sc, torch.from_numpy(a)), small)
    ng, nc = state_to_numpy(sg), state_to_numpy(sc)
    bad = [f for f in FIELDS if f not in ("surrounding", "prev_surrounding")
           and not np.array_equal(ng[f], nc[f])]
    check(not bad and np.allclose(ng["surrounding"], nc["surrounding"],
                                  rtol=SURR_RTOL, atol=SURR_ATOL),
          f"card vs CPU at 4x64: {bad}")
    log("[reference] 30 heavy ticks at 4x64: card kernels == CPU plain path")
    golden_ok = check_golden(EnvConfig, init_state, step, env_mod, dev)
    log(f"[reference] tests/golden_trajectory.json: {golden_ok} steps match")

    # ---- 6. kernel times and bounds ----
    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    n_alive = state.alive.sum(dim=1).to(torch.float64)
    ray_tests = float((n_alive * (n_alive - 1)).sum())
    ray_flops = ray_tests * (33 * 8 + 6)     # per ray test 8, per pair 6
    out_r = raycast_cuda.raycast(*ray_inputs, cfg)
    ray_bytes = nbytes(ray_inputs) + nbytes(out_r) + 4 * cfg.sensor_size
    sys_bytes = nbytes(sys_inputs) + nbytes(got)
    # The bilinear `surrounding` takes 32 FP32 ops per slot alive after
    # births; the rest of the kernel is integer work.
    alive0, health0, dmg = sys_inputs[0], sys_inputs[2], sys_inputs[12]
    h = torch.where(alive0, health0 - cfg.shoot_damage * dmg, health0)
    h = h + cfg.eat_health * got.eaten.int() - cfg.breed_cost * got.breeder.int()
    sys_flops = 32.0 * float(((alive0 & (h > 0)) | got.born).sum())

    kernels = []
    for name, route, src, replaces, kfn, pfn, nbyte, flops, reps in (
            ("systems", "cuda", "madrona_bots_tpu_torch/csrc/systems.cu",
             "madrona_bots_tpu/ops/step_pallas.py:146",
             lambda: step_cuda.systems(*sys_inputs, cfg),
             lambda: step_cuda.systems_reference(*sys_inputs, cfg),
             sys_bytes, sys_flops, 5),
            ("raycast", "cuda", "madrona_bots_tpu_torch/csrc/raycast.cu",
             "madrona_bots_tpu/ops/raycast_pallas.py:708",
             lambda: raycast_cuda.raycast(*ray_inputs, cfg),
             lambda: raycast_plain.raycast(*ray_inputs, cfg),
             ray_bytes, ray_flops, 2)):
        ms = timed(kfn, 50)
        plain_ms = timed(pfn, reps)
        bytes_ms = nbyte / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": route, "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "bytes": nbyte, "fp32_ops": flops})
    got = step_cuda.systems(*sys_inputs, cfg)
    want = step_cuda.systems_reference(*sys_inputs, cfg)
    kernels[0]["max_abs_err"] = max(float((g.float() - w.float()).abs().max())
                                    for g, w in zip(got, want))
    kernels[1]["max_abs_err"] = ray_err
    for k in kernels:
        log(f"[time] {k['name']}: {k['ms']:.4f} ms/launch, plain {k['plain_ms']:.3f} ms, "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']})")
    log(f"[time] raycast at 128 agents per world: "
        f"{timed(lambda: raycast_cuda.raycast(*sat_inputs), 10):.4f} ms/launch")

    # ---- 7. where a tick's time goes ----
    where_the_time_goes(state, sys_inputs, ray_inputs, cfg, one_hot_actions)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def where_the_time_goes(state, sys_inputs, ray_inputs, cfg, actions) -> None:
    """Host-clock ms of each piece of a tick, each call synchronised, and a
    profiler trace of two whole ticks: kernels launched and device busy time."""
    from madrona_bots_tpu_torch.env import env as env_mod
    from madrona_bots_tpu_torch.env import systems as sy
    from madrona_bots_tpu_torch.learn.obs import construct_obs
    from madrona_bots_tpu_torch.ops import raycast_cuda, step_cuda

    def host_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    s, t = state, state.step_count
    parts = {
        "actions": lambda: actions(),
        "prepass.food_spawn": lambda: sy.food_spawn(
            s.food_count, s.food_cell, s.num_food, s.world_keys, t, cfg),
        "prepass.action_system": lambda: sy.action_system(
            s.pos, s.heading, s.alive, s.species, s.action, s.finder, cfg),
        "prepass.respawn_draws": lambda: sy.respawn_draws(s.world_keys, t, cfg),
        "prepass": lambda: step_cuda.prepass(s, cfg),
        "systems_kernel": lambda: step_cuda.systems(*sys_inputs, cfg),
        "step_systems": lambda: step_cuda.fused_step_systems(s, cfg),
        "raycast_kernel": lambda: raycast_cuda.raycast(*ray_inputs, cfg),
        "shift_observations": lambda: env_mod.shift_observations(s, cfg),
        "construct_obs": lambda: construct_obs(s, cfg),
    }
    ms = {name: host_ms(fn) for name, fn in parts.items()}
    ms["postpass"] = ms["step_systems"] - ms["prepass"] - ms["systems_kernel"]
    log(f"[where] host ms per call, synchronised: {json.dumps(ms)}")

    from torch.profiler import ProfilerActivity, profile
    tick_state = state.clone()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            tick_state = env_mod.shift_observations(
                env_mod.step(env_mod.set_actions(tick_state, actions()), cfg), cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in kern) / 1e3 / 2
    launches = sum(e.count for e in kern) / 2
    top = sorted(kern, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:6]
    log(f"[where] profiled tick: {launches:.0f} device kernels, device busy "
        f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall (idle share "
        f"{1 - busy_ms / wall_ms:.3f}); top by device time: "
        + "; ".join(f"{e.key[:48]} {getattr(e, 'self_device_time_total', 0.0) / 2e3:.3f} ms"
                    for e in top))


def check_golden(EnvConfig, init_state, step, env_mod, dev) -> int:
    """Reproduce tests/golden_trajectory.json (50 steps, seed 0, 2 x 64,
    digests recorded from the JAX package) on the card's kernel path."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "golden_trajectory.json")
    golden = json.load(open(path))
    cfg = EnvConfig(num_worlds=2, init_agents=32, max_agents=64)
    state = init_state(cfg, 0, dev)
    rng = np.random.default_rng(0)
    for want in golden:
        a = np.zeros((2, 64, 6), np.int32)
        a[np.arange(2)[:, None], np.arange(64)[None, :], rng.integers(0, 6, (2, 64))] = 1
        state = step(env_mod.set_actions(state, torch.from_numpy(a).to(dev)), cfg)
        row = golden_digests(state)
        for k, v in want.items():
            check(k == "t" or row[k] == v, f"golden step {want['t']} field {k}")
    return len(golden)


def golden_digests(state) -> dict:
    """Per-field digests as tests/test_oracle_parity.py::_golden_digests."""
    row = {}
    for f in ("alive", "species", "health", "stats", "food_count", "food_cell",
              "species_counts", "finder", "sensor_depth", "sensor_semantic", "action"):
        v = np.ascontiguousarray(getattr(state, f).cpu().numpy())
        row[f] = hashlib.blake2b(v.tobytes(), digest_size=8).hexdigest()
    for f in ("pos", "heading", "reward", "surrounding"):
        v = getattr(state, f).cpu().numpy().astype(np.float64)
        q = np.ascontiguousarray(np.round(v * 4096.0).astype(np.int64))
        row[f] = hashlib.blake2b(q.tobytes(), digest_size=8).hexdigest()
    return row


if __name__ == "__main__":
    sys.exit(main())
