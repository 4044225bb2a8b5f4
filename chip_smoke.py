"""Drive the PyTorch port's world rollout, A2C training and PPO (per species
and species-stacked, tick by tick and in blocks), its SimManager surface and
the drivers built on it (legacy drivers, viewers, test driver, profiler) on
one CUDA card and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh-cards 4     # phase 11 (b) alone on 4 cards
    python3 chip_smoke.py --lcurve           # phase 12 alone

Phases (any failure ends the run with a non-zero exit and no result line):
  1. build the three kernels from madrona_bots_tpu_torch/csrc (nvcc, in
     parallel);
  2. the whole-step systems kernel (one launch: food spawn, action system,
     the per-world chain, the post-pass) against its plain version on clones
     of the same states: 8192 worlds x 128 slots after 16 plain steps of
     heavy shoot/breed, the same with food in every package, every slot
     alive, and at 256 x 128 each reward setting and the D1 / D3 quirks;
  3. the raycast kernel against its plain version on those states, on a
     saturated one (128 agents per world; 4 rollout ticks from it count the
     kernel's launches there), on two states built to tie at 8192 x 128
     (agents stacked on equal grid points, headings 0, pi/2, pi), on the
     stepped state at sensor sizes 20 and 48 (idle lanes and 4-byte dead
     rows; two rays a lane), and at the shapes where the JAX package runs
     its packed (8 x 32) and blocked (4 x 33) kernels, each with a few train
     ticks at that shape as its main path;
  4. the row-gather kernel against its plain version on the bf16 A2C tick's
     seven fields at 8192 x 128 with 10 learner rows per class, on the
     stepped and on the saturated state (rows dropped), with 3 rows per
     class (K = 12) on the stepped state, on the PPO record pack's four
     fields with 8 rows per class (K = 32), and on six fields neither
     learner has (int32 rows, widths 5 and 6, pointers off 16-byte
     alignment) so that every access path and dtype of the kernel runs;
  5. the world rollout: init_state, 64 timed ticks of set_actions -> step ->
     shift_observations, construct_obs; each kernel must launch once a tick;
     16 ticks on the kernel and the plain path must agree;
  6. the training tick of the CLI at 8192 x 128, hidden 128, bf16, 10
     learner rows per class: 8 warm-up and 32 timed ticks, one launch of
     each kernel per tick; 4 ticks on the kernel and the plain path agree;
  6b. PPO at the JAX package's bench shape (bench.py BENCH_MODE=ppo): 8192 x
     128, hidden 128, bf16, rollout 16, 1 x 8 minibatches, 8 learner rows
     per class; 1 warm-up and 4 timed iterations, 16 launches of each
     kernel an iteration, the dropped-row share; one iteration on the
     kernel and on the plain path from clones agree;
  6c. the species-stacked train tick (`--stacked`) at the train shape from
     the loop's state and parameters, stacked: 8 counted ticks (one launch
     of each kernel a tick), 4 ticks on the kernel and the plain path agree
     (parameters equal), stacked and loop ticks timed in alternation, and
     the share of actions a stacked and a loop tick from one state draw
     differently (printed, not checked);
  6d. the stacked PPO trainer at the PPO shape: 16 launches of each kernel
     an iteration, one iteration on the kernel and the plain path agree,
     stacked and loop iterations in alternation, its peak device memory;
  6e. block mode: the CLI's `make_block` with K = 16 ticks (bench.py's train
     BENCH_SCAN), best tracking on, loop and stacked: 16 launches of each
     kernel a block, ms per tick against the per-tick CLI loop, in
     alternation;
  6f. the SimManager (`api/manager.py`) at 8192 x 128, 32 initial agents:
     8 warm-up and 32 timed steps, each writing random one-hot actions
     through `action_tensor().to_torch()`, reading the 12 getters and
     shifting the observations, then 32 without the getters (ms a step by
     CUDA events; one systems and one raycast launch a step); every export
     against a gather of the state at a permutation built on the host with
     numpy; 8 steps on the kernel and on the plain path agree in every
     export (`surrounding` within its tolerance);
  7. reference checks on small inputs: the kernel path on the card against
     the plain path on the CPU (world steps, an f32 train tick and an f32
     PPO iteration, each also stacked), stacked against loop on the card
     (the same integer trajectory), the 50-step digests of
     tests/golden_trajectory.json (recorded from the JAX package), and
     SimManager(0, 4, 42, 32) on the card against the CPU for 16 steps with
     set_action write-backs (every export);
  8. the training CLI as a subprocess at --num_worlds 8, A2C and PPO
     (--rollout_len 4), each also --stacked (A2C with --ticks_per_block 4):
     create a universe, then restore it;
  9. each kernel's time per launch (the raycast also at the saturated
     state; the systems step on clones of the stepped state, made outside
     the timed window), its plain version's time, its bound, its share of
     the bound,
     its registers and spills (ptxas's report of the library this run
     loaded, kept beside it by the build) and (row gather) one PyTorch gather's
     time, with the card's clocks, temperatures and clock-event reasons
     sampled before and after; where a rollout tick's, a train tick's and a
     PPO iteration's time goes, and a profiled tick's (iteration's) kernel
     count and idle share; then a profiled stacked tick and stacked PPO
     iteration, and a profiled manager step.
  10. after every trace (traces taken after it lose kernel events): the
     legacy headless driver (`learn/env.py`) as a subprocess at 2048
     worlds, hidden 128, 32 epochs (its simulator FPS), and one f32
     `env_app` frame at 4 worlds on the card against the CPU; the stdin test
     driver (1 world) fed w, f, q and the web viewer (4 worlds, /state and
     /step over 127.0.0.1) in this process with their kernel launches
     counted; `learn.app` and `learn.env_app` for 3 headless epochs where
     matplotlib imports (else a `[viz] frames skipped` line); `tools.prof`
     at 8192 x 128.
  11. worlds-sharded scale-out (`parallel/`, `--use_mesh`), last: (a) the
     CLI at 8192 x 128, hidden 128, bf16 in this process with and without
     --use_mesh (a group of one process, NCCL): A2C with 10 learner rows, 3
     epochs, and PPO with rollout 16, 1 x 8, 8 rows, 2 iterations; their
     checkpoints equal in bits and their metrics rows but the clock's; (b)
     8 env steps, 2 A2C ticks (loop and stacked, bf16, 10 rows) and 1 PPO
     iteration at the bench shape in one process over 8192 worlds, then in
     2 processes on this card over gloo with 4096 worlds each (this script
     run with `--mesh-worker`): each rank's env shard equal in bits to its
     slice of the one-process run (after the A2C ticks, but the action and
     memory the last tick's updated policy wrote), parameters and Adam
     state within rtol 1e-3, atol 1e-4 of it and equal in bits across the
     ranks, count and dropped rows equal, one launch of each kernel a tick
     and 16 an iteration per rank; ms a tick and an iteration for one
     process and for each rank, all-reduces a tick, and the all-reduce
     alone.
  12. the learning-curve drivers (`tools/lcurve.py`) at their widths: A2C
     at 2048 worlds (raw-logit, bf16, 12 learner slots, quirk_compat), 2
     blocks of 8 epochs straight, and PPO at 8192 worlds (bf16, rollout
     16, 1 x 8, 8 slots), 2 blocks of 2 iterations straight; each again as
     1 block, a resume point, a new driver that resumes from it, 1 block:
     series, parameters, Adam state and world state equal in bits to the
     straight run; one launch of each kernel a tick and 16 an iteration in
     the straight runs; epochs/s and env-steps/s.

Prints a `kernels` JSON line (each row's `launches` from its main path's
run, `ppo_launches` in a PPO iteration at the bench shape,
`stacked_launches` in a stacked tick, `stacked_ppo_launches` in a stacked
PPO iteration, `manager_launches` in the 32 timed manager steps (rows
systems and raycast), `driver_launches` in the 4-world web viewer's and the
1-world test driver's two steps (rows raycast_packed and raycast_blocked),
`mesh_launches` by one rank in the mesh phase's counted runs (8 steps, 2 + 2
ticks, 1 iteration), `lcurve_launches` in the learning-curve phase's two
straight runs (16 A2C epochs, 4 PPO iterations)),
the card's
name and power limit, and as the last line {"ok": true, "device": {...}}.
Exits non-zero without a CUDA device or without the package beside it. Timings use CUDA events; a
kernel's time (`ms`) is the median of 5 batches of launches back to back,
beside its device time from a profiler trace (`device_ms`) and the host
time of one wrapper call (`host_ms`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import io
import json
import math
import os
import re
import shutil
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
HIDDEN, ROWS = 128, 10         # bench.py's A2C shape: hidden 128, 10 slots
TRAIN_WARM, TRAIN_TICKS = 8, 32
PPO_T, PPO_M, PPO_SLOTS = 16, 8, 8   # bench.py's PPO: rollout 16, 1 x 8, 8 slots
PPO_ITERS = 4
STACKED_TICKS, STACKED_ROUNDS = 8, 3   # stacked ticks counted; loop / stacked rounds
STACKED_PPO_ROUNDS = 2
BLOCK, BLOCK_ROUNDS = 16, 2      # bench.py's train BENCH_SCAN: 16 ticks a block
MGR_WARM, MGR_STEPS, MGR_CHECK = 8, 32, 8   # manager steps: warm-up, timed, kernel vs plain
LEGACY_WORLDS, LEGACY_EPOCHS = 2048, 32     # learn/env.py's width; 32 of its 100 epochs
LR = 3e-4
DEVICE = "cuda"
REPO = os.path.dirname(os.path.abspath(__file__))


def name_and_power() -> list:
    """Each card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()


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
    from madrona_bots_tpu_torch.ops import _build, raycast_cuda, row_gather_cuda, step_cuda

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = name_and_power()[0]
    log(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build ----
    secs, ptxas = _build.build()
    log(f"[build] {len(_build.SOURCES)} kernels ({', '.join(_build.SOURCES)}) "
        f"in {secs:.1f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or line.startswith("["):
            log("  " + line.strip())
    usage = ptxas_usage(ptxas)

    cfg = EnvConfig(num_worlds=W, init_agents=INIT, max_agents=A)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def one_hot_actions(heavy: bool = False) -> torch.Tensor:
        return random_actions(gen, dev, heavy)

    # ---- 2. the whole-step systems kernel against its plain version ----
    t0 = time.perf_counter()
    state = stepped_state(cfg, dev, one_hot_actions)
    torch.cuda.synchronize()
    log(f"[systems] 16 plain steps in {time.perf_counter() - t0:.1f} s; "
        f"alive {int(state.alive.sum())} of {W * A}")
    sat_cfg, sat = saturated_state(dev, gen)
    sys_err = 0.0
    for label, (s, c) in systems_cases(state, cfg, sat, sat_cfg, dev, gen).items():
        got = step_cuda.step_systems_cuda(s.clone(), c)
        want = step_cuda.step_systems_plain(s.clone(), c)
        torch.cuda.synchronize()
        mism, err = state_mismatches(got, want)
        n = step_counts(s, got)
        log(f"[systems] {label} ({c.num_worlds}x{c.max_agents}, reward setting "
            f"{int(c.reward_setting)}{', D1' if c.quirk_d1_stale_finder else ''}"
            f"{', D3' if c.quirk_d3_oob_reward else ''}): kernel vs plain {mism['exact']} "
            f"exact-field mismatches, {mism['surrounding']} surrounding outside tolerance "
            f"({mism['surrounding_bits']} differ in bits); {json.dumps(n)}")
        check(mism["exact"] == 0 and mism["surrounding"] == 0, f"systems {label}: {mism}")
        check(label.startswith("saturated") or n["fresh"] > 0,
              f"systems {label}: no births or respawns")
        if label == "dense_food":
            check(n["eaten"] > 0, "systems dense_food: nothing eaten")
        if label == "after_16_steps":
            check(n["food_placed"] > 0, "systems after_16_steps: no food placed")
            sys_err = err
        del got, want

    # ---- 3. raycast kernel against its plain version ----
    ray_cases = {"after_16_steps": (state, cfg), "saturated": (sat, sat_cfg)}
    ray_cases.update(tie_states(dev, gen, cfg))
    for S in (20, 48):
        ray_cases[f"sensor_size_{S}"] = (state, dataclasses.replace(cfg, sensor_size=S))
    ray_err = {}
    for label, (s, c) in ray_cases.items():
        args = (s.pos, s.heading, s.alive, s.species)
        got_r = raycast_cuda.raycast(*args, c)
        want_r = raycast_plain.raycast(*args, c)
        torch.cuda.synchronize()
        m = {n: int((g != w).sum()) for n, g, w in
             zip(("depth", "semantic", "finder"), got_r, want_r)}
        log(f"[raycast] {label} (S {c.sensor_size}, alive {int(s.alive.sum())}, finder hits "
            f"{int((want_r[2] >= 0).sum())}): kernel vs plain mismatches {json.dumps(m)}")
        check(all(v == 0 for v in m.values()), f"raycast {label}: {m}")
        ray_err[label] = max(float((g.float() - w.float()).abs().max())
                             for g, w in zip(got_r, want_r))
    ray_inputs = (state.pos, state.heading, state.alive, state.species)
    sat_inputs = (sat.pos, sat.heading, sat.alive, sat.species)
    sat_run = sat.clone()
    torch.cuda.synchronize()
    raycast_cuda.launches = 0
    for _ in range(4):
        sat_run = env_mod.shift_observations(
            step(env_mod.set_actions(sat_run, one_hot_actions()), sat_cfg), sat_cfg)
    torch.cuda.synchronize()
    sat_launches = raycast_cuda.launches
    log(f"[raycast] saturated: 4 rollout ticks at {W}x{A} from every slot alive launched "
        f"it {sat_launches} times; alive after {int(sat_run.alive.sum())}")
    check(sat_launches == 4, f"raycast saturated: {sat_launches} launches in 4 ticks")
    del sat_run
    small_rays = raycast_small_shapes(dev, gen)

    # ---- 4. row-gather kernel against its plain version ----
    gather_err = 0.0
    for label, s_, rows in (("after_16_steps", state, ROWS), ("saturated", sat, ROWS),
                            ("after_16_steps", state, 3)):
        kslot, fields, dropped, members = gather_inputs(s_, cfg.num_species, rows)
        got_g = row_gather_cuda.compact_fields(kslot, fields)
        want_g = row_gather_cuda.compact_fields_reference(kslot, fields)
        torch.cuda.synchronize()
        mism = [int((g.view(torch.int16) != w.view(torch.int16)).sum())
                for g, w in zip(got_g, want_g)]
        log(f"[row_gather] {label}, {rows} rows per class: 7 fields, kslot "
            f"{tuple(kslot.shape)}, {int((kslot >= 0).sum())} rows gathered, {dropped} of "
            f"{members} class rows dropped; kernel vs plain bit mismatches per field {mism}")
        check(sum(mism) == 0, f"row_gather {label} K={kslot.shape[1]}: {mism}")
        check(label != "saturated" or dropped > 0, "row_gather saturated: no rows dropped")
        gather_err = max([gather_err] + [float((g.float() - w.float()).abs().max())
                                         for g, w in zip(got_g, want_g)])
    ppo_gather = ppo_gather_inputs(state, cfg.num_species, gen)
    kslot, fields, dropped, members = ppo_gather
    got_g = row_gather_cuda.compact_fields(kslot, fields)
    want_g = row_gather_cuda.compact_fields_reference(kslot, fields)
    torch.cuda.synchronize()
    mism = [int((g.view(torch.int16) != w.view(torch.int16)).sum())
            for g, w in zip(got_g, want_g)]
    log(f"[row_gather] ppo_records, {PPO_SLOTS} rows per class: 4 fields (depth, semantic, "
        f"12 scalar columns, memory), kslot {tuple(kslot.shape)}, {int((kslot >= 0).sum())} "
        f"rows gathered, {dropped} of {members} class rows dropped; kernel vs plain bit "
        f"mismatches per field {mism}")
    check(sum(mism) == 0, f"row_gather ppo_records: {mism}")
    ppo_gather_err = max(float((g.float() - w.float()).abs().max())
                         for g, w in zip(got_g, want_g))
    kslot, _, _, _ = gather_inputs(state, cfg.num_species, ROWS)
    odd = odd_fields(W, A, dev, gen)
    vecs = [row_gather_cuda.vector_width(f.shape[2], f.element_size(), f.data_ptr(), 0)
            for f in odd]
    got_g = row_gather_cuda.compact_fields(kslot, odd)
    want_g = row_gather_cuda.compact_fields_reference(kslot, odd)
    torch.cuda.synchronize()
    mism = [int((g.view(torch.int16) != w.view(torch.int16)).sum())
            for g, w in zip(got_g, want_g)]
    log(f"[row_gather] odd fields {[(str(f.dtype)[6:], f.shape[2], f.data_ptr() % 16) for f in odd]}"
        f" (dtype, width, pointer mod 16), elements per access {vecs}: kernel vs plain bit "
        f"mismatches per field {mism}")
    check(sum(mism) == 0, f"row_gather odd fields: {mism}")
    check(sorted(set(vecs)) == [1, 8], f"row_gather odd fields: access paths {vecs}")
    del sat, ray_cases, odd, got_g, want_g

    # ---- 5. the world rollout ----
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

    # ---- 6. the training tick at the CLI's bench shape ----
    train = train_phase(cfg, dev)

    # ---- 6b. PPO at the bench shape ----
    ppo_run = ppo_phase(cfg, dev)

    # ---- 6c. the species-stacked tick and PPO iteration; block mode ----
    strain = stacked_train_phase(cfg, dev, train)
    sppo = stacked_ppo_phase(cfg, dev, ppo_run)
    block_phase(cfg, train, strain)

    # ---- 6f. the SimManager at the bench shape ----
    mgr_run = manager_phase(dev, gen)

    # ---- 7. reference checks on small inputs ----
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
    reference_train_tick(dev)
    reference_ppo(dev)
    reference_stacked(dev)
    reference_manager(dev)

    # ---- 8. the training CLI ----
    cli_phase()
    cli_phase(["--algo", "ppo", "--rollout_len", "4"], "ppo")
    cli_phase(["--stacked", "--ticks_per_block", "4"])
    cli_phase(["--algo", "ppo", "--stacked", "--rollout_len", "4"])

    # ---- 9. kernel times and bounds ----
    log(f"[clocks] before the kernel times: {smi_sample()}")

    kernels = [systems_row(state, cfg, sys_err, train["launches"]["systems"])]
    ray_bytes, ray_flops, ray_tests, ray_passed = raycast_bound(
        ray_inputs, raycast_cuda.raycast(*ray_inputs, cfg), cfg)
    ray_fn = lambda: raycast_cuda.raycast(*ray_inputs, cfg)  # noqa: E731
    bytes_ms = ray_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ray_flops / FP32_FLOPS * 1e3
    kernels.append({
        "name": "raycast", "route": "cuda", "source": "madrona_bots_tpu_torch/csrc/raycast.cu",
        "replaces": "madrona_bots_tpu/ops/raycast_pallas.py:708",
        "launches": train["launches"]["raycast"],
        "max_abs_err": max(v for k, v in ray_err.items() if k != "saturated"),
        "ms": timed(ray_fn, 50),
        "plain_ms": timed(lambda: raycast_plain.raycast(*ray_inputs, cfg), 2),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "bytes": ray_bytes, "fp32_ops": ray_flops,
        "ray_tests": ray_tests, "cull_passed": ray_passed,
        **launch_costs(ray_fn, "raycast_kernel")})
    kernels += [raycast_row(r, timed) for r in small_rays]
    kslot, fields, _, _ = gather_inputs(train["state"], cfg.num_species)
    kernels.append(row_gather_row("row_gather", kslot, fields, gather_err,
                                  train["launches"]["row_gather"]))
    kernels.append(raycast_row(dict(
        name="raycast_saturated", replaces="madrona_bots_tpu/ops/raycast_pallas.py:708",
        cfg=sat_cfg, inputs=sat_inputs, launches=sat_launches, err=ray_err["saturated"]),
        timed))
    kernels.append(row_gather_row("row_gather_ppo", ppo_gather[0], ppo_gather[1],
                                  ppo_gather_err, ppo_run["launches"]["row_gather"]))
    # Launches of each row's kernel at the row's shape in one PPO iteration at
    # the bench shape (the 8 x 32 and 4 x 33 shapes are not on that path).
    kernel_of = {"systems": "systems", "raycast": "raycast", "raycast_saturated": "raycast",
                 "row_gather": "row_gather", "row_gather_ppo": "row_gather"}
    for k in kernels:
        for name, per in (("ppo_launches", ppo_run["per_iteration"]),
                          ("stacked_launches", strain["per_tick"]),
                          ("stacked_ppo_launches", sppo["per_iteration"])):
            k[name] = per[kernel_of[k["name"]]] if k["name"] in kernel_of else 0
        k["manager_launches"] = (mgr_run["launches"][kernel_of[k["name"]]]
                                 if k["name"] in ("systems", "raycast") else 0)
        k["share"] = k["bound_ms"] / k["ms"]
        k.update(usage.get(os.path.basename(k["source"]),
                           {"registers": None, "spill_bytes": None}))
        lib = "" if k["library_ms"] is None else f", library {k['library_ms']:.4f} ms"
        if "ray_tests" in k:
            lib += (f", {k['fp32_ops']:.4g} FP32 ops, {k['cull_passed']:.0f} of "
                    f"{k['ray_tests']:.0f} ray tests pass the cull")
        dev_ms = "none traced" if k["device_ms"] is None else f"{k['device_ms']:.4f} ms"
        log(f"[time] {k['name']}: {k['ms']:.4f} ms/launch (device {dev_ms}, host "
            f"{k['host_ms']:.4f} ms a call; launches {k['launches']}, {k['ppo_launches']} a PPO "
            f"iteration, {k['stacked_launches']} a stacked tick, {k['stacked_ppo_launches']} a "
            f"stacked PPO iteration, {k['manager_launches']} in {MGR_STEPS} manager steps), "
            f"plain {k['plain_ms']:.3f} ms, "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}, share {k['share']:.3f}){lib}; "
            f"{k['registers']} registers, {k['spill_bytes']} spill bytes")
    log(f"[clocks] after the kernel times: {smi_sample()}")

    # ---- where a tick's time goes ----
    where_the_time_goes(state, ray_inputs, cfg, one_hot_actions)
    train_where(train, cfg)
    ppo_where(ppo_run, cfg)
    stacked_where(strain, sppo)
    manager_where(mgr_run)
    del mgr_run

    # ---- 10. the legacy drivers, the viewers, the test driver, tools.prof ----
    # After every profiler trace (PERF.md §7: traces in one process lost
    # kernel events after some of the phases before them).
    legacy_phase(dev)
    drivers = drivers_phase(dev)
    for k in kernels:
        k["driver_launches"] = {"raycast_packed": drivers["four_worlds"]["raycast"],
                                "raycast_blocked": drivers["one_world"]["raycast"]}.get(k["name"], 0)
    log("[drivers] raycast launches in the drivers' 2 steps by kernel row: "
        + json.dumps({k["name"]: k["driver_launches"] for k in kernels}))

    # ---- 11. worlds-sharded scale-out (after every trace, like 10) ----
    del train, ppo_run, strain, sppo
    torch.cuda.empty_cache()
    mesh_launches = mesh_phase(dev)
    for k in kernels:
        k["mesh_launches"] = mesh_launches[kernel_of[k["name"]]] if k["name"] in kernel_of else 0
    log("[mesh] launches by one rank in its counted runs, by kernel row: "
        + json.dumps({k["name"]: k["mesh_launches"] for k in kernels}))

    # ---- 12. the learning-curve drivers ----
    lcurve_launches = lcurve_phase(dev, smi)
    for k in kernels:
        k["lcurve_launches"] = (lcurve_launches[kernel_of[k["name"]]]
                                if k["name"] in kernel_of else 0)
    log("[lcurve] launches in the two straight runs, by kernel row: "
        + json.dumps({k["name"]: k["lcurve_launches"] for k in kernels}))

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def batch_times(fn, reps, batches=5) -> list:
    """ms per call in each of `batches` runs of `reps` calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    per_batch = []
    for _ in range(batches):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        per_batch.append(s.elapsed_time(e) / reps)
    return per_batch


def timed(fn, reps, batches=5) -> float:
    """ms per call: the median of `batch_times`, so a transient slowdown of
    the card in one batch does not set the figure."""
    return sorted(batch_times(fn, reps, batches))[batches // 2]


def launch_costs(fn, kernel: str, reps: int = 50) -> dict:
    """Where one call's time goes, after one warm-up call. `host_ms`: the
    host clock per call over `reps` calls made back to back without a wait
    (the wrapper's own work and the launch). `device_ms`: the card's time
    per call in the CUDA kernels whose name holds `kernel`, from a
    torch.profiler trace of `reps` calls (None if the trace holds none).
    CUDA events around back-to-back calls read the larger of the two."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key)
    return {"host_ms": host, "device_ms": dev_us / 1e3 / reps if dev_us else None}


def random_actions(gen, dev, heavy: bool = False, worlds: int | None = None) -> torch.Tensor:
    """Random one-hot [worlds (default W), A, 6] int32 actions; `heavy` also
    sets the shoot and breed bits at random."""
    shape = (W if worlds is None else worlds, A)
    a = torch.nn.functional.one_hot(
        torch.randint(0, 6, shape, generator=gen, device=dev), 6).to(torch.int32)
    if heavy:
        a[..., 4] |= torch.randint(0, 2, shape, generator=gen, device=dev, dtype=torch.int32)
        a[..., 5] |= torch.randint(0, 2, shape, generator=gen, device=dev, dtype=torch.int32)
    return a


def stepped_state(cfg, dev, actions):
    """The state the kernels are held and timed on: init_state (seed 7)
    after 16 plain steps of heavy shoot/breed actions, with one more set of
    heavy actions set. `actions(heavy=True)` draws them."""
    from madrona_bots_tpu_torch import init_state, step
    from madrona_bots_tpu_torch.env import env as env_mod

    state = init_state(cfg, seed=7, device=dev)
    for _ in range(16):
        state = step(env_mod.set_actions(state, actions(heavy=True)), cfg, use_kernels=False)
    env_mod.set_actions(state, actions(heavy=True))
    return state


def saturated_state(dev, gen):
    """(config, state) with every one of the W x A slots alive (seed 3) and
    random headings: where the raycast's work is largest."""
    from madrona_bots_tpu_torch import EnvConfig, init_state

    cfg = EnvConfig(num_worlds=W, init_agents=A, max_agents=A)
    state = init_state(cfg, seed=3, device=dev)
    state.heading.copy_(torch.rand((W, A), generator=gen, device=dev) * 6.28)
    return cfg, state


def host_ms(fn, reps=5):
    """Host-clock ms per call of `fn`, after one warm-up call, synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def systems_cases(state, cfg, sat, sat_cfg, dev, gen) -> dict:
    """{label: (state, config)} on which the whole-step kernel is held
    against its plain version: the stepped state (about 10% of its worlds
    open the food gate); the same with food in every package (in even
    worlds all packages of a chunk stacked on the cell where an agent of the
    chunk stands after its move, so the eat stage resolves contention);
    every slot alive (no free slot), with finders from one sensor pass; and
    at 256 x 128 one state per reward setting and the D1 / D3 quirks, each
    after 4 plain steps of heavy shoot/breed."""
    from madrona_bots_tpu_torch import EnvConfig, init_state, step
    from madrona_bots_tpu_torch.config import RewardSetting
    from madrona_bots_tpu_torch.env import env as env_mod
    from madrona_bots_tpu_torch.ops import step_cuda

    cases = {"after_16_steps": (state, cfg)}
    dense = state.clone()
    C, P, cw = cfg.num_chunks, cfg.max_food_packages, cfg.chunk_width
    inputs, _, _ = step_cuda.prepass(state.clone(), cfg)
    alive0, cidx, cell = inputs[0], inputs[6], inputs[7]
    agent_cell = torch.full((W, C + 1), -1, dtype=torch.int32, device=dev)
    agent_cell.scatter_(1, torch.where(alive0, cidx, C).long(), cell)
    agent_cell = agent_cell[:, :C, None].expand(W, C, P)
    fcell = torch.randint(0, cw * cw, (W, C, P), generator=gen, device=dev, dtype=torch.int32)
    even = (torch.arange(W, device=dev) % 2 == 0)[:, None, None]
    fcell = torch.where(even & (agent_cell >= 0), agent_cell, fcell)
    dense.food_count.fill_(1)
    dense.food_cell.copy_(torch.stack([fcell % cw, fcell // cw], dim=-1))
    dense.num_food.fill_(C * P)
    cases["dense_food"] = (dense, cfg)
    sat_s = env_mod.sensor_pass(sat.clone(), sat_cfg)
    cases["saturated"] = (env_mod.set_actions(sat_s, random_actions(gen, dev, heavy=True)),
                          sat_cfg)
    small = [(f"reward_{st.name}", dict(reward_setting=st)) for st in RewardSetting]
    small += [("quirk_d1", dict(quirk_d1_stale_finder=True)),
              ("quirk_d3", dict(quirk_d3_oob_reward=True))]
    for i, (label, over) in enumerate(small):
        c = EnvConfig(num_worlds=256, init_agents=INIT, max_agents=A, **over)
        s = init_state(c, seed=100 + i, device=dev)
        for _ in range(4):
            s = step(env_mod.set_actions(s, random_actions(gen, dev, True, 256)), c,
                     use_kernels=False)
        cases[label] = (env_mod.set_actions(s, random_actions(gen, dev, True, 256)), c)
    return cases


def state_mismatches(got, want):
    """({"exact": mismatched elements over every field but `surrounding` and
    `prev_surrounding`, "surrounding": elements of those outside rtol / atol,
    "surrounding_bits": elements that differ at all}, max |got - want| over
    all fields)."""
    from madrona_bots_tpu_torch.env.state import FIELDS

    m = {"exact": 0, "surrounding": 0, "surrounding_bits": 0}
    err = 0.0
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if f in ("surrounding", "prev_surrounding"):
            m["surrounding"] += int((~torch.isclose(g, w, rtol=SURR_RTOL, atol=SURR_ATOL)).sum())
            m["surrounding_bits"] += int((g != w).sum())
        else:
            m["exact"] += int((g != w).sum())
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
    return m, err


def step_counts(before, after) -> dict:
    """What one systems step did: slots that became alive (births and
    respawns), food packages present at step start and eaten, package
    cells the spawn wrote (placements) and the worlds that placed."""
    had, has = before.food_count > 0, after.food_count > 0
    placed = (after.food_cell != before.food_cell).any(dim=-1).sum(dim=(1, 2))
    return {"alive_before": int(before.alive.sum()), "alive_after": int(after.alive.sum()),
            "fresh": int((after.alive & ~before.alive).sum()),
            "eaten": int((had & ~has).sum()), "food_placed": int(placed.sum()),
            "worlds_placed": int((placed > 0).sum())}


def step_times(step, state, reps=10, batches=5) -> list:
    """ms per call of `step` in each of `batches` runs of `reps` calls back
    to back (CUDA events), after one warm-up call. Each call steps its own
    clone of `state`, made before the batch's first event."""
    step(state.clone())
    torch.cuda.synchronize()
    per_batch = []
    for _ in range(batches):
        states = [state.clone() for _ in range(reps)]
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        for st in states:
            step(st)
        e.record()
        torch.cuda.synchronize()
        per_batch.append(s.elapsed_time(e) / reps)
        del states
    return per_batch


def step_costs(step, state, kernel: str, reps: int = 10) -> dict:
    """`launch_costs` for a call that consumes its state: `host_ms` and
    `device_ms` over `reps` calls, each on its own clone of `state` made
    before the clock starts. `kernel` "" counts every CUDA kernel."""
    from torch.profiler import ProfilerActivity, profile

    step(state.clone())
    states = [state.clone() for _ in range(reps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for st in states:
        step(st)
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    states = [state.clone() for _ in range(reps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for st in states:
            step(st)
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key)
    return {"host_ms": host, "device_ms": dev_us / 1e3 / reps if dev_us else None}


def step_bound(before, after, cfg):
    """(bytes, FP32 operations) of one systems step from `before` to
    `after`, as this run's data needs them. Read once: `alive` of every
    slot; species, health, position, heading, action and finder of the
    slots alive at step start; the two sensor rows of the slots that stay
    alive (copied to the prev rows); per world the food tables, num_food,
    the key and (once) the step count. Written once: the new per-slot
    fields and both prev sensor rows of every slot; the hidden, action and
    prev rows of the slots cleared (dead or fresh); per world the food
    counts, the package cells the spawn changed, num_food, species counts and
    rewards; the new step count. Operations, one each for an f32 add,
    product, quotient, square root, two for a fused multiply-add: 22 for
    the move, speed, chunk and cell of a slot alive at step start, its
    glibc sin/cos in double (23) counted twice (the H100's FP64 rate
    outside the tensor cores is half its FP32 rate); the bilinear
    `surrounding` (32) and the reward (7) of each slot alive after the
    step; 6 per species reward. The threefry draws (~100 calls of 20
    integer rounds a world) are integer work, not counted."""
    Wn, An = before.alive.shape
    S, H, NS = cfg.sensor_size, cfg.hidden_state_dim, cfg.num_species
    CP = cfg.num_chunks * cfg.max_food_packages
    alive0 = int(before.alive.sum())
    alive1 = int(after.alive.sum())
    keep = int((after.alive & before.alive).sum())
    cleared = Wn * An - keep
    placed = step_counts(before, after)["food_placed"]
    reads = (Wn * An + alive0 * (4 + 4 + 8 + 4 + 24 + 4) + keep * 2 * S
             + Wn * (CP * 4 + CP * 8 + 4 + 16) + 4)
    writes = (Wn * An * (8 + 4 + 4 + 1 + 4 + 16 + 8 + 4 + 2 * S)
              + cleared * (2 * 4 * H + 24 + 8 + 8 + 24 + 16 + 4 + 4 + 4)
              + Wn * (CP * 4 + 4 + 2 * 4 * NS) + 8 * placed + 4)
    flops = (22 + 2 * 23) * alive0 + (32 + 7) * alive1 + 6 * NS * Wn
    return reads + writes, float(flops)


def systems_row(state, cfg, err, launches) -> dict:
    """Row 1 of the kernel table: the whole-step kernel and its plain
    version, each timed on clones of `state`, with the step's bound."""
    from madrona_bots_tpu_torch.ops import step_cuda

    kfn = lambda s: step_cuda.step_systems_cuda(s, cfg)  # noqa: E731
    pfn = lambda s: step_cuda.step_systems_plain(s, cfg)  # noqa: E731
    per = step_times(kfn, state)
    plain = step_times(pfn, state, reps=2, batches=3)
    nbyte, flops = step_bound(state, kfn(state.clone()), cfg)
    bytes_ms, ops_ms = nbyte / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return {"name": "systems", "route": "cuda",
            "source": "madrona_bots_tpu_torch/csrc/systems.cu",
            "replaces": "madrona_bots_tpu/ops/step_pallas.py:146", "launches": launches,
            "max_abs_err": err, "ms": sorted(per)[len(per) // 2], "batches_ms": per,
            "plain_ms": sorted(plain)[1], "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "bytes": nbyte, "fp32_ops": flops,
            **step_costs(kfn, state, "step_systems_kernel")}


def raycast_bound(inputs, outputs, cfg):
    """(bytes, FP32 ops, ray tests, tests that pass the cull) of the
    raycast on these inputs. Bytes: each input read once, each output
    written once. Ops: adds, subtractions, products and square roots, one
    each; compares and selects are not counted, nor the walls and the depth
    byte (a few ops a ray), which only lowers the bound. Each ordered pair of
    alive agents in a world takes its offset and q = r^2 - |oc|^2 (6 ops);
    each of its S + 1 ray tests (the sensor rays and the finder) tc = d . oc
    and disc = tc^2 + q (5 ops); only a test that passes the exact cull
    disc >= 0 and tc > near takes the sqrt and th = tc - sqrt(disc) (2 ops).
    The tests that pass are counted from these inputs with the plain
    version's arithmetic, one target slot at a time."""
    from madrona_bots_tpu_torch import trig
    from madrona_bots_tpu_torch.env.raycast import ray_angle_offsets

    pos, heading, alive = inputs[0], inputs[1], inputs[2]
    An = heading.shape[1]
    ang = torch.cat([heading[..., None] + ray_angle_offsets(cfg, heading.device),
                     heading[..., None]], dim=-1)                       # [W, A, S + 1]
    dx, dy = trig.sincos(ang)
    px, py = pos[..., 0], pos[..., 1]
    r2 = torch.tensor(cfg.agent_radius * cfg.agent_radius, dtype=torch.float32)
    near = torch.tensor(cfg.near, dtype=torch.float32)
    slots = torch.arange(An, device=heading.device)
    passed = torch.zeros((), dtype=torch.int64, device=heading.device)
    for b in range(An):
        ocx, ocy = px[:, b:b + 1] - px, py[:, b:b + 1] - py             # target b - source
        q = r2.to(px.device) - (ocx * ocx + ocy * ocy)
        tc = dx * ocx[..., None] + dy * ocy[..., None]
        disc = tc * tc + q[..., None]
        pair = (alive & alive[:, b:b + 1] & (slots != b))[..., None]
        passed += ((disc >= 0) & (tc > near.to(px.device)) & pair).sum()
    n_alive = alive.sum(dim=1).to(torch.float64)
    pairs = float((n_alive * (n_alive - 1)).sum())
    tests = pairs * (cfg.sensor_size + 1)
    flops = 6 * pairs + 5 * tests + 2 * float(passed)
    nbyte = sum(t.numel() * t.element_size() for t in tuple(inputs) + tuple(outputs))
    return nbyte + 4 * cfg.sensor_size, flops, tests, float(passed)


def raycast_small_shapes(dev, gen):
    """The raycast kernel at the shapes where the JAX package runs its packed
    kernel (8 worlds x 32 slots) and its blocked kernel (4 x 33, 3 species):
    kernel against plain on random populations, then 4 f32 train ticks at the
    shape, its main path there, with the launches counted."""
    from madrona_bots_tpu_torch import EnvConfig, init_state, rng
    from madrona_bots_tpu_torch.env import raycast as raycast_plain
    from madrona_bots_tpu_torch.learn import a2c
    from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
    from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator
    from madrona_bots_tpu_torch.ops import raycast_cuda

    rows = []
    for name, replaces, (w, a, ns, init) in (
            ("raycast_packed", "madrona_bots_tpu/ops/raycast_pallas.py:308", (8, 32, 4, 16)),
            ("raycast_blocked", "madrona_bots_tpu/ops/raycast_pallas.py:51", (4, 33, 3, 33))):
        c = EnvConfig(num_worlds=w, init_agents=init, max_agents=a, num_species=ns)
        lims = torch.tensor([c.world_lim_x - 1.0, c.world_lim_y - 1.0], device=dev)
        err, mism = 0.0, {}
        for density in (0.3, 0.9, 1.0):
            args = (torch.rand((w, a, 2), generator=gen, device=dev) * lims,
                    torch.rand((w, a), generator=gen, device=dev) * 6.28,
                    torch.rand((w, a), generator=gen, device=dev) < density,
                    torch.randint(1, ns + 1, (w, a), generator=gen, device=dev,
                                  dtype=torch.int32))
            got = raycast_cuda.raycast(*args, c)
            want = raycast_plain.raycast(*args, c)
            torch.cuda.synchronize()
            mism[density] = sum(int((g != v).sum()) for g, v in zip(got, want))
            err = max([err] + [float((g.float() - v.float()).abs().max())
                               for g, v in zip(got, want)])
        gen_m = SpeciesNetGenerator(c.obs_dim, 6, 32, c.hidden_state_dim, seed=1)
        models = [ActorCritic.from_generator(gen_m, device=dev) for _ in range(ns)]
        tick, opt = a2c.make_train_tick(models, c, lr=LR)
        ts = a2c.init_train_states(models, rng.key(2, dev), opt)
        st = init_state(c, 4, dev)
        torch.cuda.synchronize()
        raycast_cuda.launches = 0
        for t in range(4):
            st, ts, m = tick(st, ts, rng.key(50 + t, dev))
        torch.cuda.synchronize()
        launches = raycast_cuda.launches
        log(f"[raycast] {name} shape {w}x{a} ({ns} species): kernel vs plain mismatches "
            f"by density {json.dumps(mism)}; 4 train ticks at this shape launched it "
            f"{launches} times, alive {int(st.alive.sum())}")
        check(sum(mism.values()) == 0, f"raycast {name}: {mism}")
        check(launches == 4, f"raycast {name}: {launches} launches in 4 ticks")
        check(all(bool(torch.isfinite(v)) for v in m.values()), f"{name}: train metrics")
        rows.append(dict(name=name, replaces=replaces, cfg=c, inputs=args,
                         launches=launches, err=err))
    return rows


def smi_sample() -> str:
    """The card's clocks, power, temperatures and active clock-event reasons
    (nvidia-smi), or what nvidia-smi said when it could not tell."""
    p = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
                        "temperature.gpu,temperature.memory,clocks_event_reasons.active",
                        "--format=csv,noheader"], capture_output=True, text=True)
    return (p.stdout or p.stderr).strip().replace("\n", " | ")


def ptxas_usage(log: str) -> dict:
    """{source file: {"registers", "spill_bytes"}} from the build's
    `-Xptxas -v` report, the largest over the file's kernels."""
    usage, cur = {}, None
    for line in log.splitlines():
        m = re.match(r"\[(\w+\.cu)\]", line)
        if m:
            cur = usage.setdefault(m.group(1), {"registers": 0, "spill_bytes": 0})
        elif cur is not None:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = max(cur["registers"], int(m.group(1)))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_bytes"] = max(cur["spill_bytes"], int(m.group(1)) + int(m.group(2)))
    return usage


def tie_states(dev, gen, cfg) -> dict:
    """Two raycast inputs at cfg's shape built to tie, headings 0, pi/2 and
    pi: agents on a half-unit grid in a 12 x 12 patch, every fourth slot on
    the point of the slot before it (85% alive); and agents on integer grid
    points of the whole arena, stacked in groups of four (all alive)."""
    from types import SimpleNamespace

    Wn, An = cfg.num_worlds, cfg.max_agents
    patch = 20.0 + 0.5 * torch.randint(0, 25, (Wn, An, 2), generator=gen, device=dev).float()
    patch[:, 3::4] = patch[:, 2::4]
    some = torch.rand((Wn, An), generator=gen, device=dev) < 0.85
    some[:, 2::4] = True
    some[:, 3::4] = True
    grid = torch.stack([
        torch.randint(1, int(cfg.world_lim_x), (Wn, An // 4), generator=gen, device=dev),
        torch.randint(1, int(cfg.world_lim_y), (Wn, An // 4), generator=gen, device=dev),
    ], dim=-1).float().repeat_interleave(4, dim=1)
    headings = torch.tensor([0.0, math.pi / 2, math.pi], dtype=torch.float32, device=dev)
    out = {}
    for label, pos, alive in (("ties_half_grid_patch", patch, some),
                              ("ties_stacked_integer_grid", grid,
                               torch.ones((Wn, An), dtype=torch.bool, device=dev))):
        heading = headings[torch.randint(0, 3, (Wn, An), generator=gen, device=dev)]
        species = torch.randint(1, cfg.num_species + 1, (Wn, An), generator=gen, device=dev,
                                dtype=torch.int32)
        out[label] = (SimpleNamespace(pos=pos.contiguous(), heading=heading, alive=alive,
                                      species=species), cfg)
    return out


def raycast_row(r, timed):
    """A raycast row of the kernel table: the kernel timed on r's inputs."""
    from madrona_bots_tpu_torch.env import raycast as raycast_plain
    from madrona_bots_tpu_torch.ops import raycast_cuda

    c, args = r["cfg"], r["inputs"]
    ms = timed(lambda: raycast_cuda.raycast(*args, c), 50)
    plain_ms = timed(lambda: raycast_plain.raycast(*args, c), 5)
    nbyte, flops, tests, passed = raycast_bound(args, raycast_cuda.raycast(*args, c), c)
    bytes_ms, ops_ms = nbyte / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return {"name": r["name"], "route": "cuda",
            "source": "madrona_bots_tpu_torch/csrc/raycast.cu", "replaces": r["replaces"],
            "launches": r["launches"], "max_abs_err": r["err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "bytes": nbyte, "fp32_ops": flops, "ray_tests": tests,
            "cull_passed": passed, "shape": [c.num_worlds, c.max_agents],
            **launch_costs(lambda: raycast_cuda.raycast(*args, c), "raycast_kernel")}


def odd_fields(Wn, An, dev, gen) -> list:
    """Six [Wn, An, d] row-gather sources that no A2C tick has, so that each
    access path and source dtype of the kernel runs: int32 of width 8 (one
    8-element load) and 6, u8 of width 5, aligned bf16 of width 8, and bf16
    of width 16 and i8 of width 32 starting one element past a 16-byte
    boundary (both take 2-byte accesses)."""
    def at(offset, d, dtype, values):
        t = torch.empty(Wn * An * d + offset, dtype=dtype, device=dev)[offset:].view(Wn, An, d)
        return t.copy_(values)

    def ints(lo, hi, d, dtype=torch.int32):
        return torch.randint(lo, hi, (Wn, An, d), generator=gen, device=dev, dtype=dtype)

    def normal(d):
        return (torch.randn((Wn, An, d), generator=gen, device=dev) * 40).to(torch.bfloat16)

    return [ints(-1000, 1001, 8), ints(-1000, 1001, 6), ints(0, 256, 5, torch.uint8),
            normal(8), at(1, 16, torch.bfloat16, normal(16)),
            at(1, 32, torch.int8, ints(-128, 128, 32, torch.int8))]


def gather_inputs(state, NS, rows=ROWS):
    """The bf16 tick's row-gather inputs for `state`: (kslot, the seven
    fields, class rows dropped, class rows)."""
    from madrona_bots_tpu_torch.learn import a2c
    from madrona_bots_tpu_torch.learn.pack import (class_major, compact_slots,
                                                   kslot_from_class_slots)

    m_full, lm_full = a2c.class_masks(state, NS)
    Wn = m_full.shape[0]
    m = class_major(m_full, NS)
    slot, valid, keep = compact_slots(m, rows)
    kslot = kslot_from_class_slots(slot, valid, Wn, NS)
    return (kslot, a2c.learner_fields(state, lm_full), int(m.sum() - keep.sum()),
            int(m.sum()))


def row_gather_row(name, kslot, fields, err, launches):
    """A row-gather row of the kernel table, timed on these inputs (row 5:
    the trained state's seven A2C fields; `row_gather_ppo`: the PPO record
    pack's four). The library call is one torch.gather of the same rows
    from the fields concatenated in bf16 beforehand."""
    from madrona_bots_tpu_torch.ops import row_gather_cuda

    ms = timed(lambda: row_gather_cuda.compact_fields(kslot, fields), 50)
    plain_ms = timed(lambda: row_gather_cuda.compact_fields_reference(kslot, fields), 10)
    payload = torch.cat([f.to(torch.bfloat16) for f in fields], dim=-1)
    idx = kslot.clamp(min=0).long()[:, :, None].expand(-1, -1, payload.shape[-1]).contiguous()
    library_ms = timed(lambda: torch.gather(payload, 1, idx), 50)
    Wn, K = kslot.shape
    gathered = int((kslot >= 0).sum())
    nbyte = (kslot.numel() * 4
             + gathered * sum(f.shape[2] * f.element_size() for f in fields)
             + Wn * K * sum(f.shape[2] for f in fields) * 2)
    return {"name": name, "route": "cuda",
            "source": "madrona_bots_tpu_torch/csrc/row_gather.cu",
            "replaces": "madrona_bots_tpu/ops/row_gather.py:50", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbyte / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library_ms, "bytes": nbyte, "rows_gathered": gathered,
            **launch_costs(lambda: row_gather_cuda.compact_fields(kslot, fields),
                           "row_gather_kernel")}


def train_phase(cfg, dev) -> dict:
    """The CLI's train tick at the bench shape: bf16 forwards, 10 learner
    rows per class. 8 warm-up and 32 timed ticks (CUDA events), each ending
    in the CLI's one copy of the stacked metrics; then 4 ticks on the kernel
    and on the plain path from cloned state, parameters and key."""
    from madrona_bots_tpu_torch import init_state, rng
    from madrona_bots_tpu_torch.config import NUM_ACTIONS
    from madrona_bots_tpu_torch.env.state import FIELDS
    from madrona_bots_tpu_torch.learn import a2c
    from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
    from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator

    gen = SpeciesNetGenerator(cfg.obs_dim, NUM_ACTIONS, HIDDEN, cfg.hidden_state_dim, seed=0)
    models = [ActorCritic.from_generator(gen, device=dev) for _ in range(cfg.num_species)]
    kw = dict(lr=LR, compute_dtype=torch.bfloat16, learner_slots_per_class=ROWS)
    tick, opt = a2c.make_train_tick(models, cfg, **kw)
    tstates = a2c.init_train_states(models, rng.key(0, dev), opt)
    p0 = [t.params.clone() for t in tstates]
    state = init_state(cfg, 0, dev)
    key = rng.key(1, dev)

    def run(n, state, tstates, key, host_rows):
        m = None
        for _ in range(n):
            key, sub = rng.split(key, 2)
            state, tstates, m = tick(state, tstates, sub)
            host_rows.append(a2c.stack_metrics(m).cpu())   # the CLI's one copy
        return state, tstates, key, m

    t0 = time.perf_counter()
    state, tstates, key, m = run(TRAIN_WARM, state, tstates, key, [])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host_rows = []
    host0 = time.perf_counter()
    start.record()
    state, tstates, key, m = run(TRAIN_TICKS, state, tstates, key, host_rows)
    end.record()
    torch.cuda.synchronize()
    host_ms_tick = (time.perf_counter() - host0) * 1e3 / TRAIN_TICKS
    launches = read_launches()
    ms = start.elapsed_time(end) / TRAIN_TICKS
    log(f"[train] {TRAIN_TICKS} ticks at {cfg.num_worlds}x{cfg.max_agents}, hidden {HIDDEN}, "
        f"bf16, {ROWS} learner rows per class (warm-up {TRAIN_WARM} ticks {warm_s:.1f} s): "
        f"{ms:.3f} ms/tick, {cfg.num_worlds * 1000.0 / ms:.1f} env-steps/s (CUDA events; "
        f"host clock {host_ms_tick:.3f} ms/tick)")
    log(f"[train] launches {json.dumps(launches)}")
    check(launches == {k: TRAIN_TICKS for k in launches}, f"train launches {launches}")
    hist = torch.stack(host_rows)
    names = list(m)
    check(bool(torch.isfinite(hist).all()), "train metrics not finite")
    moved = max(float((t.params - p).abs().max()) for t, p in zip(tstates, p0))
    check(moved > 0, "train: parameters did not move")
    col = {n: i for i, n in enumerate(names)}
    NS = cfg.num_species
    count = sum(float(hist[:, col[f"species_{s}_count"]].sum()) for s in range(1, NS + 1))
    dropped = sum(float(hist[:, col[f"species_{s}_dropped_rows"]].sum())
                  for s in range(1, NS + 1))
    last = {n: round(float(v), 5) for n, v in zip(names, hist[-1])
            if n.startswith("species_1_")}
    log(f"[train] metrics finite; params moved (max |delta| {moved:.3e}); dropped-row share "
        f"{dropped / max(count, 1.0):.6f} ({dropped:.0f} of {count:.0f} class rows); "
        f"species 1 last tick {json.dumps(last)}")

    tick_plain, _ = a2c.make_train_tick(models, cfg, use_kernels=False, **kw)
    ks, ps = state.clone(), state.clone()
    kts = tuple(clone_train_state(t) for t in tstates)
    pts = tuple(clone_train_state(t) for t in tstates)
    for t in range(4):
        sub = rng.fold_in(key, 1000 + t)
        ks, kts, _ = tick(ks, kts, sub)
        ps, pts, _ = tick_plain(ps, pts, sub)
    torch.cuda.synchronize()
    diff = {f: int((getattr(ks, f) != getattr(ps, f)).sum()) for f in FIELDS}
    pdiff = max(float((a.params - b.params).abs().max()) for a, b in zip(kts, pts))
    log(f"[train] 4 ticks kernels vs plain: {sum(diff.values())} state mismatches "
        f"(actions {diff['action']}, hidden {diff['hidden']}); params max |diff| {pdiff:.3e}")
    check(sum(diff.values()) == 0, f"train kernel vs plain: {diff}")
    check(pdiff == 0.0 or pdiff < 1e-6, f"train kernel vs plain params {pdiff}")
    del ks, ps, kts, pts
    return dict(state=state, tstates=tstates, models=models, tick=tick, metrics=m,
                launches=launches, ms=ms, key=key)


def reference_train_tick(dev) -> None:
    """An f32 train tick at 4 x 64 on the card against the same tick on the
    CPU's plain path, twice: from init, then from the CPU's state and
    parameters after one tick."""
    from madrona_bots_tpu_torch import EnvConfig, init_state, rng
    from madrona_bots_tpu_torch.config import NUM_ACTIONS
    from madrona_bots_tpu_torch.env.state import FIELDS, state_from_numpy, state_to_numpy
    from madrona_bots_tpu_torch.learn import a2c
    from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
    from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator

    small = EnvConfig(num_worlds=4, init_agents=32, max_agents=64)
    gen = SpeciesNetGenerator(small.obs_dim, NUM_ACTIONS, 32, small.hidden_state_dim, seed=2)
    models = [ActorCritic.from_generator(gen) for _ in range(small.num_species)]
    tick, opt = a2c.make_train_tick(models, small, lr=LR)
    tc = a2c.init_train_states(models, rng.key(3), opt)
    sc = init_state(small, 5, "cpu")
    floats = ("hidden", "prev_hidden", "surrounding", "prev_surrounding")
    for t in range(2):
        sg = state_from_numpy(state_to_numpy(sc), dev)
        tg = tuple(a2c.SpeciesTrainState(x.params.to(dev), a2c.AdamState(
            *(y.to(dev) for y in x.opt_state))) for x in tc)
        sc, tc, _ = tick(sc, tc, rng.key(40 + t))
        sg, tg, _ = tick(sg, tg, rng.key(40 + t, dev))
        ng, nc = state_to_numpy(sg), state_to_numpy(sc)
        bad = [f for f in FIELDS if f not in floats and not np.array_equal(ng[f], nc[f])]
        hid = float(np.abs(ng["hidden"] - nc["hidden"]).max())
        diff = torch.cat([(g.params.cpu() - c.params).abs() for g, c in zip(tg, tc)])
        sure = torch.cat([c.opt_state.mu.abs() >= 1e-7 for c in tc])
        well = float(diff[sure].max())
        log(f"[reference] f32 train tick {t + 1} at 4x64, card vs CPU: exact-field "
            f"mismatches {bad}; hidden max |diff| {hid:.3e}; params max |diff| "
            f"{float(diff.max()):.3e} ({well:.3e} where |mu| >= 1e-7)")
        check(not bad and hid <= 1e-5 and well <= (1e-6 if t == 0 else 1e-5)
              and float(diff.max()) <= 2 * LR, f"train tick card vs CPU, tick {t + 1}")


def ppo_gather_inputs(state, NS, gen):
    """The PPO record pack's row-gather inputs on `state`, with random
    actions, log-probabilities, values and memory: (kslot [W, NS *
    PPO_SLOTS], the four fields of `ppo.record_fields`, class rows dropped,
    class rows)."""
    from madrona_bots_tpu_torch.learn import a2c, ppo
    from madrona_bots_tpu_torch.learn.pack import (class_major, compact_slots,
                                                   kslot_from_class_slots)

    m_full, _ = a2c.class_masks(state, NS)
    Wn, An = m_full.shape
    dev = m_full.device
    m = class_major(m_full, NS)
    slot, valid, keep = compact_slots(m, PPO_SLOTS)
    kslot = kslot_from_class_slots(slot, valid, Wn, NS)
    action = torch.randint(0, 6, (Wn, An), generator=gen, device=dev) * m_full
    logp = -3.0 * torch.rand((Wn, An), generator=gen, device=dev) * m_full
    value = 10.0 * torch.randn((Wn, An), generator=gen, device=dev) * m_full
    s = state.replace(hidden=torch.randn(state.hidden.shape, generator=gen, device=dev))
    return (kslot, ppo.record_fields(s, action, logp, value), int(m.sum() - keep.sum()),
            int(m.sum()))


def metrics_close(got: dict, want: dict, rtol: float = 1e-4, atol: float = 1e-5) -> list:
    """Names of the metrics outside rtol / atol (dropped rows: not equal)."""
    bad = []
    for k, w in want.items():
        g, w = float(got[k]), float(w)
        if (g != w) if k.endswith("_dropped_rows") else abs(g - w) > atol + rtol * abs(w):
            bad.append(k)
    return bad


def ppo_phase(cfg, dev) -> dict:
    """PPO as the JAX package's bench.py BENCH_MODE=ppo runs it: init_state
    seed 0, train states from key(1), iteration i keyed fold_in(key(2), i);
    bf16, rollout 16, 1 x 8 minibatches, 8 learner rows per class. 1 warm-up
    and 4 timed iterations (CUDA events), each ending in the CLI's one
    metrics copy; then one iteration on the kernel and on the plain path
    from cloned state, parameters and key."""
    from madrona_bots_tpu_torch import init_state, rng
    from madrona_bots_tpu_torch.config import NUM_ACTIONS
    from madrona_bots_tpu_torch.learn import a2c, ppo
    from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
    from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator

    NS = cfg.num_species
    gen = SpeciesNetGenerator(cfg.obs_dim, NUM_ACTIONS, HIDDEN, cfg.hidden_state_dim, seed=0)
    models = [ActorCritic.from_generator(gen, device=dev) for _ in range(NS)]
    kw = dict(rollout_len=PPO_T, num_minibatches=PPO_M, compute_dtype=torch.bfloat16,
              learner_slots_per_class=PPO_SLOTS)
    it, opt = ppo.make_ppo_trainer(models, cfg, **kw)
    tstates = a2c.init_train_states(models, rng.key(1, dev), opt)
    p0 = [t.params.clone() for t in tstates]
    state = init_state(cfg, 0, dev)
    key = rng.key(2, dev)
    t0 = time.perf_counter()
    state, tstates, m = it(state, tstates, rng.fold_in(key, 0))
    a2c.stack_metrics(m).cpu()
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    held_mb = torch.cuda.memory_allocated(dev) / 2**20
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host_rows = []
    host0 = time.perf_counter()
    start.record()
    for i in range(PPO_ITERS):
        state, tstates, m = it(state, tstates, rng.fold_in(key, 1 + i))
        host_rows.append(a2c.stack_metrics(m).cpu())      # the CLI's one copy
    end.record()
    torch.cuda.synchronize()
    host_ms_it = (time.perf_counter() - host0) * 1e3 / PPO_ITERS
    launches = read_launches()
    ms = start.elapsed_time(end) / PPO_ITERS
    log(f"[ppo] {PPO_ITERS} iterations at {cfg.num_worlds}x{cfg.max_agents}, hidden {HIDDEN}, "
        f"bf16, rollout {PPO_T}, 1 x {PPO_M} minibatches, {PPO_SLOTS} learner rows per class "
        f"(warm-up 1 iteration {warm_s:.1f} s): {ms:.3f} ms/iteration, "
        f"{cfg.num_worlds * PPO_T * 1000.0 / ms:.1f} env-steps/s (CUDA events; host clock "
        f"{host_ms_it:.3f} ms/iteration)")
    log(f"[ppo] device memory: {held_mb:.0f} MiB allocated before the timed iterations "
        f"(this phase's state and nets and the earlier phases' tensors), peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB during them")
    check(launches == {k: PPO_T * PPO_ITERS for k in launches}, f"ppo launches {launches}")
    per_iteration = {k: v // PPO_ITERS for k, v in launches.items()}
    log(f"[ppo] launches per iteration {json.dumps(per_iteration)}")
    hist = torch.stack(host_rows)
    names = list(m)
    check(bool(torch.isfinite(hist).all()), "ppo metrics not finite")
    moved = max(float((t.params - p).abs().max()) for t, p in zip(tstates, p0))
    check(moved > 0, "ppo: parameters did not move")
    col = {n: i for i, n in enumerate(names)}
    rows = PPO_T * sum(float(hist[:, col[f"species_{s}_count"]].sum()) for s in range(1, NS + 1))
    dropped = sum(float(hist[:, col[f"species_{s}_dropped_rows"]].sum()) for s in range(1, NS + 1))
    last = {n: round(float(v), 5) for n, v in zip(names, hist[-1]) if n.startswith("species_1_")}
    log(f"[ppo] metrics finite; params moved (max |delta| {moved:.3e}); dropped-row share "
        f"{dropped / max(rows, 1.0):.6f} ({dropped:.0f} of {rows:.0f} class rows); species 1 "
        f"last iteration {json.dumps(last)}")

    it_plain, _ = ppo.make_ppo_trainer(models, cfg, use_kernels=False, **kw)
    ks, ps = state.clone(), state.clone()
    kts = tuple(clone_train_state(t) for t in tstates)
    pts = tuple(clone_train_state(t) for t in tstates)
    sub = rng.fold_in(key, 1000)
    t0 = time.perf_counter()
    ks, kts, km = it(ks, kts, sub)
    ps, pts, pm = it_plain(ps, pts, sub)
    torch.cuda.synchronize()
    mism, _ = state_mismatches(ks, ps)
    pdiff = max(float((a.params - b.params).abs().max()) for a, b in zip(kts, pts))
    bad = metrics_close(km, pm)
    log(f"[ppo] 1 iteration kernels vs plain ({time.perf_counter() - t0:.1f} s): "
        f"{mism['exact']} exact-field mismatches, {mism['surrounding']} surrounding outside "
        f"tolerance; params max |diff| {pdiff:.3e}; metrics outside tolerance {bad}")
    check(mism["exact"] == 0 and mism["surrounding"] == 0, f"ppo kernel vs plain: {mism}")
    check(pdiff <= 1e-6 and not bad, f"ppo kernel vs plain params {pdiff}, metrics {bad}")
    del ks, ps, kts, pts
    return dict(state=state, tstates=tstates, models=models, it=it, metrics=m, key=key,
                launches=launches, per_iteration=per_iteration, ms=ms)


def reference_ppo(dev) -> None:
    """An f32 PPO iteration at 4 x 64 (rollout 4, 2 minibatches, 8 learner
    rows per class) on the card against the same iteration on the CPU's
    plain path, from the same state, parameters and key."""
    from madrona_bots_tpu_torch import EnvConfig, init_state, rng
    from madrona_bots_tpu_torch.config import NUM_ACTIONS
    from madrona_bots_tpu_torch.env.state import FIELDS, state_from_numpy, state_to_numpy
    from madrona_bots_tpu_torch.learn import a2c, ppo
    from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
    from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator

    small = EnvConfig(num_worlds=4, init_agents=32, max_agents=64)
    gen = SpeciesNetGenerator(small.obs_dim, NUM_ACTIONS, 32, small.hidden_state_dim, seed=4)
    models = [ActorCritic.from_generator(gen) for _ in range(small.num_species)]
    kw = dict(rollout_len=4, num_minibatches=2, learner_slots_per_class=8)
    it_cpu, opt = ppo.make_ppo_trainer(models, small, use_kernels=False, **kw)
    it_card, _ = ppo.make_ppo_trainer(models, small, **kw)
    tc = a2c.init_train_states(models, rng.key(3), opt)
    sc = init_state(small, 6, "cpu")
    sg = state_from_numpy(state_to_numpy(sc), dev)
    tg = tuple(a2c.SpeciesTrainState(x.params.to(dev), a2c.AdamState(
        *(y.to(dev) for y in x.opt_state))) for x in tc)
    sc, tc, mc = it_cpu(sc, tc, rng.key(60))
    sg, tg, mg = it_card(sg, tg, rng.key(60, dev))
    ng, nc = state_to_numpy(sg), state_to_numpy(sc)
    floats = ("hidden", "surrounding")
    bad = [f for f in FIELDS if f not in floats and not np.array_equal(ng[f], nc[f])]
    hid = float(np.abs(ng["hidden"] - nc["hidden"]).max())
    surr = np.allclose(ng["surrounding"], nc["surrounding"], rtol=SURR_RTOL, atol=SURR_ATOL)
    diff = torch.cat([(g.params.cpu() - c.params).abs() for g, c in zip(tg, tc)])
    sure = torch.cat([c.opt_state.mu.abs() >= 1e-7 for c in tc])
    well = float(diff[sure].max())
    mbad = metrics_close({k: float(v) for k, v in mg.items()}, mc)
    log(f"[reference] f32 PPO iteration at 4x64 (rollout 4, 2 minibatches, 8 learner rows), "
        f"card vs CPU: exact-field mismatches {bad}; hidden max |diff| {hid:.3e}; params max "
        f"|diff| {float(diff.max()):.3e} ({well:.3e} where |mu| >= 1e-7); metrics outside "
        f"tolerance {mbad}; dropped rows {sum(float(v) for k, v in mc.items() if 'dropped' in k):.0f}")
    check(not bad and surr and hid <= 1e-5 and well <= 1e-6 and float(diff.max()) <= 2 * LR
          and not mbad, "PPO iteration card vs CPU")


def clone_train_state(ts):
    """A copy of one train state (a species' or the stacked one)."""
    from madrona_bots_tpu_torch.learn.a2c import AdamState, SpeciesTrainState
    return SpeciesTrainState(ts.params.clone(), AdamState(*(x.clone() for x in ts.opt_state)))


def reset_launches() -> None:
    from madrona_bots_tpu_torch.ops import raycast_cuda, row_gather_cuda, step_cuda
    step_cuda.launches = raycast_cuda.launches = row_gather_cuda.launches = 0


def read_launches() -> dict:
    from madrona_bots_tpu_torch.ops import raycast_cuda, row_gather_cuda, step_cuda
    return {"systems": step_cuda.launches, "raycast": raycast_cuda.launches,
            "row_gather": row_gather_cuda.launches}


def events_ms(fn, n: int = 1) -> float:
    """CUDA-event ms per unit of one call of `fn` that does `n` units."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def stacked_states(sac, tstates):
    """The stacked train state of per-species train states."""
    from madrona_bots_tpu_torch.learn.a2c import SpeciesTrainState
    return SpeciesTrainState(sac.stack_params([t.params for t in tstates]),
                             sac.stack_opt_state([t.opt_state for t in tstates]))


def stacked_train_phase(cfg, dev, train) -> dict:
    """The species-stacked train tick at the bench shape (hidden 128, bf16,
    10 learner rows per class) from the loop's trained state and parameters,
    stacked: STACKED_TICKS counted ticks (one launch of each kernel a tick);
    4 ticks on the kernel and on the plain path agree; stacked and loop ticks
    timed in alternation by CUDA events; the share of
    actions a stacked and a loop tick from one state draw differently."""
    from madrona_bots_tpu_torch import rng
    from madrona_bots_tpu_torch.env.state import FIELDS
    from madrona_bots_tpu_torch.learn import a2c
    from madrona_bots_tpu_torch.models.stacked import StackedActorCritic, stackable

    models = train["models"]
    check(stackable([m.config for m in models]), "stacked: seed 0's configs are not stackable")
    sac = StackedActorCritic(models)
    log(f"[stacked] train: depths {sac.depths}, cells {sac.cells}, {sac.num_params} stacked "
        f"parameters ({sum(m.num_params for m in models)} unpadded)")
    kw = dict(lr=LR, compute_dtype=torch.bfloat16, learner_slots_per_class=ROWS)
    tick, _ = a2c.make_train_tick(models, cfg, stacked=True, **kw)
    state, ts = train["state"].clone(), stacked_states(sac, train["tstates"])
    key = rng.key(21, dev)

    def run(n, state, ts, key):
        m = None
        for _ in range(n):
            key, sub = rng.split(key, 2)
            state, ts, m = tick(state, ts, sub)
            a2c.stack_metrics(m).cpu()                    # the CLI's one copy
        return state, ts, key, m

    t0 = time.perf_counter()
    state, ts, key, m = run(4, state, ts, key)
    warm_s = time.perf_counter() - t0
    held = [state, ts, key]

    def stacked_ticks(n):
        held[0], held[1], held[2], _ = run(n, *held)

    reset_launches()
    ms = events_ms(lambda: stacked_ticks(STACKED_TICKS), STACKED_TICKS)
    launches = read_launches()
    per_tick = {k: v // STACKED_TICKS for k, v in launches.items()}
    log(f"[stacked] train: {STACKED_TICKS} stacked ticks at {cfg.num_worlds}x{cfg.max_agents}, "
        f"hidden {HIDDEN}, bf16, {ROWS} learner rows per class (warm-up 4 ticks "
        f"{warm_s:.1f} s): {ms:.3f} ms/tick, {cfg.num_worlds * 1000.0 / ms:.1f} env-steps/s; "
        f"launches {json.dumps(launches)}")
    check(launches == {k: STACKED_TICKS for k in launches}, f"stacked launches {launches}")
    state, ts = held[0], held[1]
    check(all(bool(torch.isfinite(v)) for v in m.values()), "stacked metrics not finite")

    # Kernel path against plain path, from clones.
    tick_plain, _ = a2c.make_train_tick(models, cfg, stacked=True, use_kernels=False, **kw)
    ks, ps, kts, pts = state.clone(), state.clone(), clone_train_state(ts), clone_train_state(ts)
    for t in range(4):
        sub = rng.fold_in(key, 1000 + t)
        ks, kts, _ = tick(ks, kts, sub)
        ps, pts, _ = tick_plain(ps, pts, sub)
    torch.cuda.synchronize()
    diff = {f: int((getattr(ks, f) != getattr(ps, f)).sum()) for f in FIELDS}
    pdiff = float((kts.params - pts.params).abs().max())
    log(f"[stacked] train: 4 ticks kernels vs plain: {sum(diff.values())} state mismatches "
        f"(actions {diff['action']}, hidden {diff['hidden']}); params max |diff| {pdiff:.3e}")
    check(sum(diff.values()) == 0 and pdiff == 0.0, f"stacked kernel vs plain: {diff}, {pdiff}")
    del ks, ps, kts, pts

    # The share of actions that differ between a loop and a stacked tick
    # from one state, parameters and key (printed, not checked).
    loop_tick = train["tick"]
    base, lts = train["state"], train["tstates"]
    sub = rng.key(33, dev)
    sl, _, _ = loop_tick(base.clone(), tuple(clone_train_state(t) for t in lts), sub)
    ss, _, _ = tick(base.clone(), stacked_states(sac, lts), sub)
    rows = sl.alive | ss.alive
    differ = int(((sl.action != ss.action).any(dim=-1) & rows).sum())
    share = differ / max(int(rows.sum()), 1)
    log(f"[stacked] train: one loop and one stacked tick from one state and key: {differ} of "
        f"{int(rows.sum())} alive rows drew another action (share {share:.6f}; cuBLAS's batched "
        "and single products need not agree in bits)")
    del sl, ss

    # Stacked and loop ticks in alternation, CUDA events.
    lheld = [base.clone(), tuple(clone_train_state(t) for t in lts), rng.key(44, dev)]

    def loop_ticks(n):
        for _ in range(n):
            lheld[2], sub = rng.split(lheld[2], 2)
            lheld[0], lheld[1], lm = loop_tick(lheld[0], lheld[1], sub)
            a2c.stack_metrics(lm).cpu()

    rounds = {"loop": [], "stacked": []}
    for _ in range(STACKED_ROUNDS):
        rounds["loop"].append(events_ms(lambda: loop_ticks(8), 8))
        rounds["stacked"].append(events_ms(lambda: stacked_ticks(8), 8))
    med = {k: sorted(v)[len(v) // 2] for k, v in rounds.items()}
    log(f"[stacked] train: ms/tick in alternation, 8 ticks a round, {STACKED_ROUNDS} rounds "
        f"(CUDA events): loop {json.dumps(rounds['loop'])}, stacked "
        f"{json.dumps(rounds['stacked'])}; medians loop {med['loop']:.3f}, stacked "
        f"{med['stacked']:.3f} (stacked / loop {med['stacked'] / med['loop']:.3f})")
    del lheld

    return dict(tick=tick, sac=sac, state=held[0], tstates=held[1], per_tick=per_tick,
                ms=med["stacked"], loop_ms=med["loop"], whole=lambda: stacked_ticks(1))


def stacked_ppo_phase(cfg, dev, run) -> dict:
    """The stacked PPO trainer at the PPO bench shape from the loop phase's
    state and parameters, stacked: 1 warm-up and 1 counted iteration (16
    launches of each kernel), peak device memory; one iteration on the
    kernel and on the plain path agree; stacked and loop iterations in
    alternation. `whole` runs one more iteration, for `stacked_where`."""
    from madrona_bots_tpu_torch import rng
    from madrona_bots_tpu_torch.learn import a2c, ppo
    from madrona_bots_tpu_torch.models.stacked import StackedActorCritic

    models, NS = run["models"], cfg.num_species
    sac = StackedActorCritic(models)
    kw = dict(rollout_len=PPO_T, num_minibatches=PPO_M, compute_dtype=torch.bfloat16,
              learner_slots_per_class=PPO_SLOTS)
    it, _ = ppo.make_ppo_trainer(models, cfg, stacked=True, **kw)
    key = run["key"]
    held = [run["state"].clone(), stacked_states(sac, run["tstates"]), 0]
    p0 = held[1].params.clone()

    def iterate():
        held[2] += 1
        held[0], held[1], m = it(held[0], held[1], rng.fold_in(key, 2000 + held[2]))
        return a2c.stack_metrics(m).cpu(), m

    t0 = time.perf_counter()
    iterate()
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mb = torch.cuda.memory_allocated(dev) / 2**20
    reset_launches()
    out = []
    ms = events_ms(lambda: out.append(iterate()))
    launches = read_launches()
    hist, m = out[0]
    log(f"[stacked] ppo: 1 stacked iteration at {cfg.num_worlds}x{cfg.max_agents}, hidden "
        f"{HIDDEN}, bf16, rollout {PPO_T}, 1 x {PPO_M}, {PPO_SLOTS} learner rows (warm-up "
        f"{warm_s:.1f} s): {ms:.3f} ms/iteration, "
        f"{cfg.num_worlds * PPO_T * 1000.0 / ms:.1f} env-steps/s; launches "
        f"{json.dumps(launches)}; device memory {base_mb:.0f} MiB before, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB during it")
    check(launches == {k: PPO_T for k in launches}, f"stacked ppo launches {launches}")
    check(bool(torch.isfinite(hist).all()), "stacked ppo metrics not finite")
    moved = float((held[1].params - p0).abs().max())
    check(moved > 0, "stacked ppo: parameters did not move")

    it_plain, _ = ppo.make_ppo_trainer(models, cfg, stacked=True, use_kernels=False, **kw)
    ks, ps = held[0].clone(), held[0].clone()
    kts, pts = clone_train_state(held[1]), clone_train_state(held[1])
    sub = rng.fold_in(key, 3000)
    t0 = time.perf_counter()
    ks, kts, km = it(ks, kts, sub)
    ps, pts, pm = it_plain(ps, pts, sub)
    torch.cuda.synchronize()
    mism, _ = state_mismatches(ks, ps)
    pdiff = float((kts.params - pts.params).abs().max())
    bad = metrics_close(km, pm)
    log(f"[stacked] ppo: 1 iteration kernels vs plain ({time.perf_counter() - t0:.1f} s): "
        f"{mism['exact']} exact-field mismatches, {mism['surrounding']} surrounding outside "
        f"tolerance; params max |diff| {pdiff:.3e}; metrics outside tolerance {bad}")
    check(mism["exact"] == 0 and mism["surrounding"] == 0 and pdiff == 0.0 and not bad,
          f"stacked ppo kernel vs plain: {mism}, {pdiff}, {bad}")
    del ks, ps, kts, pts

    lheld = [run["state"].clone(), tuple(clone_train_state(t) for t in run["tstates"]), 0]

    def loop_iterate():
        lheld[2] += 1
        lheld[0], lheld[1], lm = run["it"](lheld[0], lheld[1], rng.fold_in(key, 4000 + lheld[2]))
        a2c.stack_metrics(lm).cpu()

    rounds = {"loop": [], "stacked": []}
    for _ in range(STACKED_PPO_ROUNDS):
        rounds["loop"].append(events_ms(loop_iterate))
        rounds["stacked"].append(events_ms(iterate))
    med = {k: sorted(v)[len(v) // 2] for k, v in rounds.items()}
    log(f"[stacked] ppo: ms/iteration in alternation, {STACKED_PPO_ROUNDS} rounds (CUDA "
        f"events): loop {json.dumps(rounds['loop'])}, stacked {json.dumps(rounds['stacked'])}; "
        f"medians loop {med['loop']:.1f}, stacked {med['stacked']:.1f} (stacked / loop "
        f"{med['stacked'] / med['loop']:.3f})")
    del lheld

    return dict(per_iteration=launches, ms=med["stacked"], loop_ms=med["loop"],
                whole=iterate)


def stacked_where(strain, sppo) -> None:
    """Profiler traces of two stacked ticks and one stacked PPO iteration:
    device kernels, busy time and idle share against the unprofiled time.
    They run after every other trace: a short trace taken after a large one
    lost kernel events in the same process."""
    for label, fn, n, ms in (("stacked tick", strain["whole"], 2, host_ms(strain["whole"])),
                             ("stacked ppo iteration", sppo["whole"], 1, sppo["ms"])):
        launched, busy_ms, wall_ms, kern = traced(fn, n)
        top = sorted(kern, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:6]
        log(f"[where] profiled {label}: {launched:.0f} device kernels, device busy "
            f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall (idle share "
            f"{1 - busy_ms / wall_ms:.3f}; against the unprofiled {ms:.3f} ms: "
            f"{max(0.0, 1 - busy_ms / ms):.3f}); top by device time: "
            + "; ".join(f"{e.key[:48]} {getattr(e, 'self_device_time_total', 0.0) / n / 1e3:.3f}"
                        f" ms ({e.count // n})" for e in top))


def block_phase(cfg, train, strain) -> None:
    """The CLI's block (`training_loop.make_block`) at the bench train shape
    with K = BLOCK ticks, best tracking on, loop and stacked: the launches of
    one block counted, then ms per tick of a block (its metrics, best values
    and indices copied out) against the per-tick CLI loop (a split, a tick
    and the metrics copy a tick), in alternation by CUDA events."""
    from madrona_bots_tpu_torch import rng
    from madrona_bots_tpu_torch.learn import a2c
    from madrona_bots_tpu_torch.learn.training_loop import BEST_METRICS, make_block

    NS, dev = cfg.num_species, train["state"].alive.device
    modes = {"loop": (train["tick"], lambda ts, sp: ts[sp], train["state"],
                      tuple(clone_train_state(t) for t in train["tstates"])),
             "stacked": (strain["tick"], lambda ts, sp: ts, strain["state"],
                         clone_train_state(strain["tstates"]))}
    times = {}
    for name, (tick, view, state0, ts0) in modes.items():
        block = make_block(tick, BLOCK, NS, view, True)
        held = [state0.clone(), ts0, rng.key(55, dev)]
        best = torch.full((len(BEST_METRICS), NS), float("inf"), device=dev)

        def one_block():
            held[2], sub = rng.split(held[2], 2)
            held[0], held[1], ms, bv, _, bidx, _ = block(held[0], held[1], sub, best)
            return ms.cpu(), bv.cpu(), bidx.cpu()

        def per_tick():
            for _ in range(BLOCK):
                held[2], sub = rng.split(held[2], 2)
                held[0], held[1], m = tick(held[0], held[1], sub)
                a2c.stack_metrics(m).cpu()

        one_block()                                            # warm-up
        reset_launches()
        out = one_block()
        launches = read_launches()
        check(launches == {k: BLOCK for k in launches}, f"block {name} launches {launches}")
        check(tuple(out[0].shape) == (BLOCK, len(a2c.METRIC_NAMES) * NS)
              and bool(torch.isfinite(out[0]).all()), f"block {name} metrics")
        check(bool((out[2] >= 0).all()), f"block {name}: no best tracked from inf")
        rounds = {"block": [], "per_tick": []}
        for _ in range(BLOCK_ROUNDS):
            rounds["block"].append(events_ms(one_block, BLOCK))
            rounds["per_tick"].append(events_ms(per_tick, BLOCK))
        times[name] = {k: sorted(v)[len(v) // 2] for k, v in rounds.items()}
        log(f"[block] {name}: K = {BLOCK} at {cfg.num_worlds}x{cfg.max_agents}, best tracking "
            f"on: launches a block {json.dumps(launches)}; ms/tick in alternation "
            f"({BLOCK_ROUNDS} rounds, CUDA events): block {json.dumps(rounds['block'])}, "
            f"per-tick CLI loop {json.dumps(rounds['per_tick'])}; medians block "
            f"{times[name]['block']:.3f}, per tick {times[name]['per_tick']:.3f}")
        del held


def reference_stacked(dev) -> None:
    """At 4 x 64 in f32: two stacked ticks and one stacked PPO iteration on
    the card against the same on the CPU's plain path (the tolerances of
    the loop's reference checks); and on the card, stacked against loop
    (4 ticks, 2 PPO iterations): the same integer state trajectory."""
    from madrona_bots_tpu_torch import EnvConfig, init_state, rng
    from madrona_bots_tpu_torch.config import NUM_ACTIONS
    from madrona_bots_tpu_torch.env.state import FIELDS, state_from_numpy, state_to_numpy
    from madrona_bots_tpu_torch.learn import a2c, ppo
    from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
    from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator

    small = EnvConfig(num_worlds=4, init_agents=32, max_agents=64)
    gen = SpeciesNetGenerator(small.obs_dim, NUM_ACTIONS, 32, small.hidden_state_dim, seed=0)
    models = [ActorCritic.from_generator(gen) for _ in range(small.num_species)]
    floats = ("hidden", "prev_hidden", "surrounding", "prev_surrounding")

    def to_card(ts):
        return a2c.SpeciesTrainState(ts.params.to(dev), a2c.AdamState(
            *(y.to(dev) for y in ts.opt_state)))

    def compare(label, sg, tg, sc, tc, well_tol, mg=None, mc=None):
        ng, nc = state_to_numpy(sg), state_to_numpy(sc)
        bad = [f for f in FIELDS if f not in floats and not np.array_equal(ng[f], nc[f])]
        hid = float(np.abs(ng["hidden"] - nc["hidden"]).max())
        surr = np.allclose(ng["surrounding"], nc["surrounding"], rtol=SURR_RTOL, atol=SURR_ATOL)
        diff = (tg.params.cpu() - tc.params).abs()
        well = float(diff[tc.opt_state.mu.abs() >= 1e-7].max())
        mbad = [] if mg is None else metrics_close({k: float(v) for k, v in mg.items()}, mc)
        log(f"[reference] {label} at 4x64, card vs CPU: exact-field mismatches {bad}; hidden "
            f"max |diff| {hid:.3e}; params max |diff| {float(diff.max()):.3e} ({well:.3e} "
            f"where |mu| >= 1e-7){'' if mg is None else f'; metrics outside tolerance {mbad}'}")
        check(not bad and surr and hid <= 1e-5 and well <= well_tol
              and float(diff.max()) <= 2 * LR and not mbad, f"{label} card vs CPU")

    tick, opt = a2c.make_train_tick(models, small, lr=LR, learner_slots_per_class=8, stacked=True)
    tc = a2c.init_stacked_train_state(models, rng.key(3), opt)
    sc = init_state(small, 5, "cpu")
    for t in range(2):
        sg, tg = state_from_numpy(state_to_numpy(sc), dev), to_card(tc)
        sc, tc, _ = tick(sc, tc, rng.key(40 + t))
        sg, tg, _ = tick(sg, tg, rng.key(40 + t, dev))
        compare(f"f32 stacked train tick {t + 1}", sg, tg, sc, tc, 1e-6 if t == 0 else 1e-5)

    kw = dict(rollout_len=4, num_minibatches=2, learner_slots_per_class=8, stacked=True)
    it_cpu, opt = ppo.make_ppo_trainer(models, small, use_kernels=False, **kw)
    it_card, _ = ppo.make_ppo_trainer(models, small, **kw)
    tc = a2c.init_stacked_train_state(models, rng.key(3), opt)
    sc = init_state(small, 6, "cpu")
    sg, tg = state_from_numpy(state_to_numpy(sc), dev), to_card(tc)
    sc, tc, mc = it_cpu(sc, tc, rng.key(60))
    sg, tg, mg = it_card(sg, tg, rng.key(60, dev))
    compare("f32 stacked PPO iteration (rollout 4, 2 minibatches, 8 learner rows)",
            sg, tg, sc, tc, 1e-6, mg, mc)

    ints = ("alive", "species", "health", "action", "pos", "food_count", "finder")
    for label, make, n in (("ticks", a2c.make_train_tick, 4),
                           ("PPO iterations", ppo.make_ppo_trainer, 2)):
        extra = (dict(lr=LR) if make is a2c.make_train_tick
                 else dict(rollout_len=4, num_minibatches=2))
        f_l, opt_l = make(models, small, learner_slots_per_class=8, **extra)
        f_s, opt_s = make(models, small, learner_slots_per_class=8, stacked=True, **extra)
        ts_l = tuple(to_card(t) for t in a2c.init_train_states(models, rng.key(3), opt_l))
        ts_s = to_card(a2c.init_stacked_train_state(models, rng.key(3), opt_s))
        st_l, st_s = init_state(small, 7, dev), init_state(small, 7, dev)
        mism = {}
        for t in range(n):
            k = rng.key(70 + t, dev)
            st_l, ts_l, _ = f_l(st_l, ts_l, k)
            st_s, ts_s, _ = f_s(st_s, ts_s, k)
            for f in ints:
                mism[f] = mism.get(f, 0) + int((getattr(st_l, f) != getattr(st_s, f)).sum())
        log(f"[reference] f32 stacked vs loop on the card, {n} {label} at 4x64: integer state "
            f"mismatches {json.dumps(mism)}")
        check(sum(mism.values()) == 0, f"stacked vs loop {label}: {mism}")


def cli_phase(flags=(), label: str = "") -> None:
    """The training CLI in a subprocess at --num_worlds 8 with `flags`:
    create a universe with 3 epochs, then restore it for 2 more."""
    import glob
    import tempfile

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        save = os.path.join(tmp, "ckpts")
        base = ([sys.executable, "-m", "madrona_bots_tpu_torch.learn.training_loop",
                 "--num_worlds", "8", "--hidden_dim", "32", "--universe_id", "smoke",
                 "--model_save_dir", save] + list(flags) + device_flag())
        env = subprocess_env()
        outs = []
        for extra in (["--num_epochs", "3", "--create_universe"], ["--num_epochs", "2"]):
            t0 = time.perf_counter()
            p = subprocess.run(base + extra, cwd=tmp, env=env, capture_output=True,
                               text=True, timeout=600)
            if p.returncode != 0:
                log(p.stdout[-2000:] + p.stderr[-4000:])
            check(p.returncode == 0, f"CLI {' '.join(extra)} exited {p.returncode}")
            fps = [ln for ln in p.stdout.splitlines() if ln.startswith("Average FPS")]
            check(bool(fps), "CLI printed no Average FPS line")
            outs.append((time.perf_counter() - t0, fps[0], p.stdout))
        latest = sorted(os.path.relpath(f, save) for f in glob.glob(
            os.path.join(save, "universe_smoke", "species_*", "latest_model_epoch_*.ckpt.npz")))
        want = [f"universe_smoke/species_{s}/latest_model_epoch_5.ckpt.npz" for s in range(1, 5)]
        check(latest == want, f"CLI checkpoints {latest}")
        check("Loading model from" in outs[1][2], "CLI restore did not load")
    log(f"[cli]{''.join(' ' + w for w in (label, *flags) if w)} create (3 epochs) "
        f"{outs[0][0]:.1f} s, {outs[0][1]}; restore (2 epochs) {outs[1][0]:.1f} s, "
        f"{outs[1][1]}; latest_model_epoch_5 for 4 species")


MANAGER_GETTERS = ("depth", "semantic", "reward", "position", "health", "surrounding",
                   "action", "stats", "hidden_state")


def manager_getters(mgr, prev=(False, True)) -> dict:
    """The SimManager's exports as its device tensors: the 12 getters
    (species_count, done, sensor_index and nine that also take is_prev),
    each of the nine for every is_prev in `prev`."""
    out = {"species_count": mgr.species_count_tensor().to_torch(),
           "done": mgr.done_tensor().to_torch(),
           "sensor_index": mgr.sensor_index_tensor().to_torch()}
    for p in prev:
        for name in MANAGER_GETTERS:
            out[f"{name}_{int(p)}"] = getattr(mgr, f"{name}_tensor")(p).to_torch()
    return out


def host_exports(state, num_species):
    """(exports, species starts) built on the host with numpy from one copy
    of `state`, in the order of the JAX package's numpy compaction
    (madrona_bots_tpu/utils/native.py:129-140): species-major, ascending
    flat index within a species."""
    from madrona_bots_tpu_torch.env.state import state_to_numpy

    st = state_to_numpy(state)
    alive = st["alive"].reshape(-1)
    sp = st["species"].reshape(-1).astype(np.int64)
    flat = np.arange(alive.size)
    key = np.where(alive, sp * alive.size + flat, np.iinfo(np.int64).max)
    perm = np.argsort(key, kind="stable")[: int(alive.sum())]
    counts = np.bincount(sp[perm], minlength=num_species + 1)[1:]
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    inv = np.full(alive.size, -1, np.int32)
    inv[perm] = np.arange(perm.size, dtype=np.int32)

    def rows(f):
        return st[f].reshape((alive.size,) + st[f].shape[2:])[perm]

    out = {"species_count": st["species_counts"],
           "done": np.zeros((perm.size, 1), np.int32),
           "sensor_index": inv[np.flatnonzero(alive)][:, None]}
    for p in (0, 1):
        pre = "prev_" if p else ""
        out.update({f"depth_{p}": rows(pre + "sensor_depth"),
                    f"semantic_{p}": rows(pre + "sensor_semantic"),
                    f"reward_{p}": rows(pre + "reward")[:, None],
                    f"position_{p}": rows(pre + "pos"),
                    f"health_{p}": rows(pre + "health")[:, None].astype(np.float32),
                    f"surrounding_{p}": rows(pre + "surrounding"),
                    f"action_{p}": rows(pre + "action"),
                    f"stats_{p}": rows(pre + "stats"),
                    f"hidden_state_{p}": rows(pre + "hidden")})
    return out, starts


def exports_mismatch(got: dict, want: dict) -> dict:
    """{export: elements that differ} between two export dicts (torch or
    numpy values); `surrounding_*` also counted outside the surrounding
    tolerance (key `*_outside_tol`). Dtype or shape differences count every
    element."""
    bad = {}
    for k, w in want.items():
        g, w = (np.ascontiguousarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)
                for x in (got[k], w))
        if g.dtype != w.dtype or g.shape != w.shape:
            bad[k] = max(g.size, w.size, 1)
            continue
        n = int((g.view(np.uint8) != w.view(np.uint8)).reshape(g.shape + (-1,)).any(-1).sum()) \
            if g.size else 0
        if n:
            bad[k] = n
        if k.startswith("surrounding"):
            out = int((~np.isclose(g, w, rtol=SURR_RTOL, atol=SURR_ATOL)).sum())
            if out:
                bad[k + "_outside_tol"] = out
    return bad


def exact_except_surrounding(bad: dict) -> bool:
    """No export differs but `surrounding` in bits inside its tolerance."""
    return all(k.startswith("surrounding") and not k.endswith("_outside_tol")
               for k in bad)


def manager_phase(dev, gen) -> dict:
    """[manager]: the SimManager at 8192 x 128 (32 initial agents). Each step
    writes random one-hot actions through `action_tensor().to_torch()`,
    steps, reads the 12 getters (or not) and shifts the observations; ms a
    step by CUDA events with and without the getters, one systems and one
    raycast launch a step; every export against a gather of the state at
    a permutation built on the host with numpy; 8 steps on the kernel path
    against the plain path. `res["step"]` steps its manager once more
    (`manager_where` traces it)."""
    from madrona_bots_tpu_torch.api import SimManager

    acts = [random_actions(gen, dev).reshape(W * A, 6) for _ in range(4)]
    heavy = [random_actions(gen, dev, heavy=True).reshape(W * A, 6) for _ in range(4)]
    t0 = time.perf_counter()
    mgr = SimManager(0, W, 0, INIT, device=dev)
    init_s = time.perf_counter() - t0

    def write(m, a):
        buf = m.action_tensor().to_torch()
        buf.copy_(a[: buf.shape[0]])

    def steps(n, read):
        for i in range(n):
            write(mgr, acts[i % 4])
            mgr.step()
            if read:
                manager_getters(mgr, prev=(False,))
            mgr.shift_observations()

    steps(MGR_WARM, True)
    res = {"init_s": init_s}
    for label, read in (("getters", True), ("no_getters", False)):
        torch.cuda.synchronize()
        reset_launches()
        h0 = time.perf_counter()
        ms = events_ms(lambda: steps(MGR_STEPS, read), MGR_STEPS)
        host = (time.perf_counter() - h0) * 1e3 / MGR_STEPS
        launches = read_launches()
        res[label] = {"ms": ms, "host_ms": host, "launches": launches}
        log(f"[manager] {MGR_STEPS} steps at {W}x{A} (init {INIT}), {label.replace('_', ' ')}: "
            f"{ms:.3f} ms/step by events ({W * 1000.0 / ms:.1f} env-steps/s; host clock "
            f"{host:.3f}), launches {json.dumps(launches)}, alive {mgr.total_num_agents}")
        check(launches == {"systems": MGR_STEPS, "raycast": MGR_STEPS, "row_gather": 0},
              f"manager launches ({label}): {launches}")
    res["launches"] = res["getters"]["launches"]

    write(mgr, heavy[0])
    mgr.step()
    want, starts = host_exports(mgr.state, mgr.cfg.num_species)
    bad = exports_mismatch(manager_getters(mgr), want)
    n = mgr.total_num_agents
    log(f"[manager] {len(want)} exports ({n} rows, species starts {starts.tolist()}) against "
        f"a gather at the host-built numpy permutation: mismatching elements {json.dumps(bad)}")
    check(not bad and np.array_equal(mgr.species_offsets(), starts)
          and n == int(starts[-1]), f"manager exports vs host permutation: {bad}")
    check(0 < n <= W * A, f"manager population {n}")
    res["rows"] = n

    res["step"] = lambda: steps(1, True)       # kept for the profiled step
    del want

    mk = SimManager(0, W, 5, INIT, device=dev)
    mp = SimManager(0, W, 5, INIT, device=dev, use_kernels=False)
    worst = {}
    for t in range(MGR_CHECK):
        for m in (mk, mp):
            write(m, heavy[t % 4])
        reset_launches()
        mp.step()
        plain_launches = read_launches()
        mk.step()
        check(plain_launches == {"systems": 0, "raycast": 0, "row_gather": 0},
              f"plain manager launched {plain_launches}")
        check(mk.total_num_agents == mp.total_num_agents,
              f"manager kernel vs plain, step {t}: rows {mk.total_num_agents} vs "
              f"{mp.total_num_agents}")
        bad = exports_mismatch(manager_getters(mk), manager_getters(mp))
        for k, v in bad.items():
            worst[k] = max(worst.get(k, 0), v)
        check(exact_except_surrounding(bad), f"manager kernel vs plain, step {t}: {bad}")
        if t % 2:
            mk.shift_observations()
            mp.shift_observations()
    log(f"[manager] {MGR_CHECK} steps kernel path vs plain path, every export after each: "
        f"most elements differing in any step {json.dumps(worst)} (surrounding held within "
        f"rtol {SURR_RTOL}, atol {SURR_ATOL}); alive {mk.total_num_agents}")
    del mk, mp
    return res


def manager_where(run) -> None:
    """A profiled manager step with the getters read (two steps traced):
    device kernels, busy time and idle share. Taken after every other
    trace: a manager trace taken first in the process preceded kernel
    events missing from the later traces."""
    launches, busy_ms, wall_ms, kern = traced(run["step"], 2)
    top = sorted(kern, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:4]
    log(f"[where] profiled manager step with getters: {launches:.0f} device kernels, device "
        f"busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall (idle share {1 - busy_ms / wall_ms:.3f}; "
        f"against the unprofiled {run['getters']['ms']:.3f} ms: "
        f"{max(0.0, 1 - busy_ms / run['getters']['ms']):.3f}); top by device time: "
        + "; ".join(f"{e.key[:40]} {getattr(e, 'self_device_time_total', 0.0) / 2e3:.3f} ms"
                    for e in top))


def reference_manager(dev) -> None:
    """[manager] reference: SimManager(0, 4, 42, 32) on the card against the
    same on the CPU, 16 steps of the same actions and hidden writes (with
    set_action write-backs), every export after each step."""
    from madrona_bots_tpu_torch.api import SimManager

    mg = SimManager(0, 4, 42, 32, device=dev)
    mc = SimManager(0, 4, 42, 32, device="cpu")
    rng = np.random.default_rng(42)
    worst = {}
    for t in range(16):
        n = mc.total_num_agents
        check(mg.total_num_agents == n, f"manager card vs CPU, step {t}: rows")
        a = np.zeros((n, 6), np.int32)
        a[np.arange(n), rng.integers(0, 6, n)] = 1
        a[:, 4] |= rng.integers(0, 2, n).astype(np.int32)
        h = rng.standard_normal((n, mc.cfg.hidden_state_dim)).astype(np.float32)
        for m in (mg, mc):
            m.action_tensor().to_torch().copy_(torch.from_numpy(a))
            m.hidden_state_tensor().to_torch().copy_(torch.from_numpy(h))
            if t % 4 == 1:
                for row in (0, n // 3, n - 1):
                    m.set_action(row, forward=1, backward=0, rotate_left=0,
                                 rotate_right=1, shoot=0, breed=1)
        mg.step()
        mc.step()
        bad = exports_mismatch(manager_getters(mg), manager_getters(mc))
        for k, v in bad.items():
            worst[k] = max(worst.get(k, 0), v)
        check(exact_except_surrounding(bad)
              and np.array_equal(mg.species_offsets(), mc.species_offsets()),
              f"manager card vs CPU, step {t}: {bad}")
        if t % 2:
            mg.shift_observations()
            mc.shift_observations()
    log(f"[manager] reference: SimManager(0, 4, 42, 32) card vs CPU, 16 steps with "
        f"set_action write-backs: every export equal (most elements differing in any step "
        f"{json.dumps(worst)}, surrounding within tolerance); alive {mg.total_num_agents}")


def subprocess_env() -> dict:
    """This environment with the repo first on PYTHONPATH."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))


def device_flag() -> list:
    """The entry points' `--device` flag: none on the card, their default."""
    return [] if DEVICE == "cuda" else ["--device", DEVICE]


def legacy_phase(dev) -> dict:
    """[legacy]: the legacy headless driver (learn/env.py) as a subprocess at
    2048 worlds, hidden 128, 32 epochs; then one f32 env_app frame at 4
    worlds on the card against the CPU."""
    from madrona_bots_tpu_torch import rng
    from madrona_bots_tpu_torch.api import SimManager
    from madrona_bots_tpu_torch.env.state import FIELDS, state_to_numpy
    from madrona_bots_tpu_torch.learn import env as legacy_env
    from madrona_bots_tpu_torch.learn import env_app

    cmd = [sys.executable, "-m", "madrona_bots_tpu_torch.learn.env", "--num_worlds",
           str(LEGACY_WORLDS), "--num_epochs", str(LEGACY_EPOCHS)] + device_flag()
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=REPO, env=subprocess_env(), capture_output=True, text=True,
                       timeout=600)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        log(p.stdout[-2000:] + p.stderr[-4000:])
    check(p.returncode == 0, f"legacy driver exited {p.returncode}")
    fps = [ln for ln in p.stdout.splitlines() if ln.startswith("Average FPS for simulator")]
    check(bool(fps), "legacy driver printed no Average FPS line")
    fps_value = float(fps[0].split(":")[1])
    check(math.isfinite(fps_value) and fps_value > 0, f"legacy FPS {fps_value}")
    log(f"[legacy] python -m madrona_bots_tpu_torch.learn.env --num_worlds {LEGACY_WORLDS} "
        f"--num_epochs {LEGACY_EPOCHS} (hidden 128): {fps[0]}; {wall:.1f} s wall "
        f"(process start and kernel load included)")

    args = legacy_env.build_parser().parse_args(["--num_worlds", "4", "--seed", "69"])
    runs = {}
    for d in (dev, torch.device("cpu")):
        mgr = SimManager(0, 4, 69, 32, device=d)
        models, opt, params, opt_states = legacy_env.init_models(args, d)
        env_app.make_train_step(models, opt, params, opt_states, 4,
                                [rng.key(70, d)])(mgr)
        runs[d.type] = (state_to_numpy(mgr.state), params, opt_states)
    (ng, pg, sg), (nc, pc, sc) = runs[dev.type], runs["cpu"]
    ints = [f for f in FIELDS if ng[f].dtype.kind in "iub"]
    bad = [f for f in ints if not np.array_equal(ng[f], nc[f])]
    # The legacy loss sums over rows, so a gradient entry near 1e-6 can be
    # below the rounding of its sum on either device, and Adam's first step
    # (lr * g / (|g| + eps)) turns that into up to 2 lr. So the gradient is
    # held through the first moment (0.1 g) at test_torch_a2c.py's f32
    # tolerance, and the parameters within 1e-6 where |mu| >= 1e-4 of the
    # largest |mu| and within 2 lr everywhere.
    diff = torch.cat([(g.cpu() - c).abs() for g, c in zip(pg, pc)])
    mu_g = torch.cat([s.mu.cpu() for s in sg])
    mu_c = torch.cat([s.mu for s in sc])
    scale = float(mu_c.abs().max())
    mom_bad = int((~torch.isclose(mu_g, mu_c, rtol=1e-4, atol=1e-4 * scale)).sum())
    sure = mu_c.abs() >= 1e-4 * scale
    well = float(diff[sure].max())
    small = float(diff[mu_c.abs() >= 1e-7].max())
    log(f"[legacy] f32 env_app frame at 4 worlds, card vs CPU: integer-field mismatches "
        f"{bad} (actions {int(ng['action'].sum())} set); first moments outside rtol 1e-4, "
        f"atol 1e-4 x {scale:.3e}: {mom_bad} of {mu_c.numel()}; params max |diff| "
        f"{float(diff.max()):.3e} ({well:.3e} where |mu| >= 1e-4 x max, {small:.3e} "
        f"where |mu| >= 1e-7)")
    check(not bad and mom_bad == 0 and well <= 1e-6 and float(diff.max()) <= 2 * LR,
          "env_app frame card vs CPU")
    return {"fps": fps_value, "wall_s": wall}


def drivers_phase(dev) -> dict:
    """[drivers]: the stdin test driver (1 world) fed w, f, q and the web
    viewer (4 worlds) over 127.0.0.1 in this process, counting their kernel
    launches; the app and env_app mains as subprocesses where matplotlib
    imports; tools.prof at 8192 x 128."""
    import tempfile
    import threading
    import urllib.request

    from madrona_bots_tpu_torch.tools import prof, test_driver
    from madrona_bots_tpu_torch.viz.web import WebViewer, make_server

    reset_launches()
    out, stdin = io.StringIO(), sys.stdin
    sys.stdin = io.StringIO("w\nf\nq\n")
    try:
        with contextlib.redirect_stdout(out):
            test_driver.main(device_flag())
    finally:
        sys.stdin = stdin
    one = read_launches()
    lines = out.getvalue().splitlines()
    depth = [ln.split() for ln in lines if len(ln.split()) == 32]
    log(f"[drivers] test_driver (1 world x 16) fed w, f, q: {len(depth)} depth rows, last "
        f"{' '.join(depth[-1]) if depth else None}; launches {json.dumps(one)}")
    check(len(depth) == 2 and lines[-1] == "bye"
          and all(0 <= int(v) <= 255 for row in depth for v in row), "test driver output")
    check(one == {"systems": 2, "raycast": 2, "row_gather": 0}, f"test driver launches {one}")

    reset_launches()
    viewer = WebViewer(num_worlds=4, seed=0, init_agents=32, device=dev)
    srv = make_server(viewer, 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        s0 = json.loads(urllib.request.urlopen(url + "/state", timeout=120).read())
        s1 = json.loads(urllib.request.urlopen(url + "/step?keys=w", timeout=120).read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    four = read_launches()
    log(f"[drivers] web viewer (4 worlds x 32): /state step {s0['step']} alive {s0['alive']}, "
        f"/step?keys=w step {s1['step']} alive {s1['alive']}, {len(s1['agents'])} agents and "
        f"{len(s1['food'])} food shown; launches {json.dumps(four)}")
    check(s1["step"] == s0["step"] + 1 and len(s1["depth"]) == 32 and s1["alive"] > 0
          and all(math.isfinite(a["x"]) and math.isfinite(a["y"]) for a in s1["agents"]),
          "web viewer snapshots")
    check(four == {"systems": 2, "raycast": 2, "row_gather": 0}, f"web viewer launches {four}")

    if importlib.util.find_spec("matplotlib") is None:
        log("[viz] frames skipped: no matplotlib")
    else:
        build = os.path.join(REPO, "build")
        os.makedirs(build, exist_ok=True)
        for mod, extra in (("app", []), ("env_app", ["--num_worlds", "4"])):
            with tempfile.TemporaryDirectory(dir=build) as tmp:
                t0 = time.perf_counter()
                p = subprocess.run(
                    [sys.executable, "-m", f"madrona_bots_tpu_torch.learn.{mod}",
                     "--num_epochs", "3", *extra] + device_flag(),
                    cwd=tmp, env=dict(subprocess_env(), MPLBACKEND="Agg"),
                    capture_output=True, text=True, timeout=600)
                if p.returncode != 0:
                    log(p.stdout[-2000:] + p.stderr[-4000:])
                check(p.returncode == 0, f"{mod} exited {p.returncode}")
                frames = os.listdir(os.path.join(tmp, "viewer_frames"))
                check(len(frames) >= 1, f"{mod}: no frames")
                log(f"[viz] learn.{mod} 3 headless epochs: {len(frames)} frames, "
                    f"{time.perf_counter() - t0:.1f} s wall")

    ms = prof.main([str(W), str(A), "16"])
    log(f"[drivers] tools.prof {W} {A} 16: {json.dumps(ms)} ms/step")
    check(all(math.isfinite(v) and v > 0 for v in ms.values()), f"tools.prof {ms}")
    return {"one_world": one, "four_worlds": four, "prof": ms}


def train_where(train, cfg) -> None:
    """Host-clock ms of each piece of a bf16 train tick at the bench shape,
    each call synchronised, and a profiler trace of two whole ticks."""
    from madrona_bots_tpu_torch import rng
    from madrona_bots_tpu_torch.config import NUM_ACTIONS
    from madrona_bots_tpu_torch.env import env as env_mod
    from madrona_bots_tpu_torch.learn import a2c
    from madrona_bots_tpu_torch.learn.pack import expand_scatter
    from madrona_bots_tpu_torch.ops import row_gather_cuda

    bf16 = torch.bfloat16
    s = train["state"].clone()
    models, tstates, tick = train["models"], train["tstates"], train["tick"]
    NS, D, H = cfg.num_species, cfg.obs_dim, cfg.hidden_state_dim
    Wn, An = s.alive.shape
    n, c0 = Wn * ROWS, 2 * D + 2 * H
    dev = s.alive.device
    opt = a2c.make_optimizer(LR)
    grec4, slot, valid_g, _, _ = a2c.compact_learner_rows(s, cfg, ROWS, bf16)
    kslot, fields, _, _ = gather_inputs(s, NS)
    valid3 = valid_g.reshape(NS, Wn, ROWS)
    ups = []
    for i in range(NS):
        g, vm = grec4[i], valid3[i].reshape(n).float()
        ups.append((g[..., :D].reshape(n, D), g[..., D:2 * D].reshape(n, D),
                    g[..., 2 * D:2 * D + H].reshape(n, H), g[..., 2 * D + H:c0].reshape(n, H),
                    g[..., c0 + 1].long().reshape(n),
                    sum(g[..., c0 + 2 + j].float() for j in range(3)).reshape(n),
                    vm, g[..., c0].float().reshape(n) * vm))

    def forwards():
        with torch.no_grad():
            for m, ts, u in zip(models, tstates, ups):
                leaves = [t.to(bf16) for t in m.unflatten(ts.params)]
                m(u[0], u[2].to(bf16), leaves)
                m(u[1], u[3].to(bf16), leaves)

    def updates():
        for i, (m, ts, u) in enumerate(zip(models, tstates, ups)):
            grad = a2c._species_grad(m, ts, *u[:7], rng.key(i, dev), 1.0, False, bf16,
                                     loss_mask=u[7])[0]
            opt.update(grad, ts.opt_state, ts.params)

    src = torch.zeros((NS * Wn, ROWS, NUM_ACTIONS + H), dtype=bf16, device=dev)
    held = [train["state"].clone(), tstates]
    key = rng.key(7, dev)

    def whole():
        held[0], held[1], m = tick(held[0], held[1], key)
        a2c.stack_metrics(m).cpu()

    parts = {
        "env_step": lambda: env_mod.step(s, cfg),
        "compaction": lambda: a2c.compact_learner_rows(s, cfg, ROWS, bf16),
        "row_gather_kernel": lambda: row_gather_cuda.compact_fields(kslot, fields),
        "forwards": forwards,
        "species_updates": updates,
        "write_back": lambda: (expand_scatter(src, slot, valid_g, An // NS),
                               env_mod.shift_observations(s, cfg)),
        "metrics_copy": lambda: a2c.stack_metrics(train["metrics"]).cpu(),
        "whole_tick": whole,
    }
    ms = {name: host_ms(fn) for name, fn in parts.items()}
    ms["backward_adam_metrics"] = ms["species_updates"] - ms["forwards"]
    log(f"[where] train tick host ms per call, synchronised: {json.dumps(ms)}")

    launched, busy_ms, wall_ms, kern = traced(whole, 2)
    top = sorted(kern, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:6]
    log(f"[where] profiled train tick: {launched:.0f} device kernels, device busy "
        f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall (idle share "
        f"{1 - busy_ms / wall_ms:.3f}; against the unprofiled whole_tick "
        f"{ms['whole_tick']:.3f} ms: {max(0.0, 1 - busy_ms / ms['whole_tick']):.3f}); top by "
        "device time: "
        + "; ".join(f"{e.key[:48]} {getattr(e, 'self_device_time_total', 0.0) / 2e3:.3f} ms"
                    for e in top))


def traced(fn, n: int):
    """Trace `n` calls of `fn` with torch.profiler: (device kernels a call,
    device busy ms a call, profiled wall ms a call, the kernels' profiler
    events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in kern) / 1e3 / n
    return sum(e.count for e in kern) / n, busy_ms, wall_ms, kern


def ppo_where(run, cfg) -> None:
    """Host-clock ms of each piece of a PPO iteration at the bench shape,
    each call synchronised, and a profiler trace of one whole iteration.
    Pieces that consume a state step a clone (`state_clone` times one)."""
    from madrona_bots_tpu_torch import rng
    from madrona_bots_tpu_torch.env import env as env_mod
    from madrona_bots_tpu_torch.learn import a2c, ppo
    from madrona_bots_tpu_torch.ops import row_gather_cuda

    it, tstates, base = run["it"], run["tstates"], run["state"]
    params = [t.params for t in tstates]
    dev = base.alive.device
    key = rng.key(11, dev)
    action, logp, value, _, obs = it.policy_step(params, base, key)
    end_state, end_key, roll = it.rollout(base.clone(), params, key)
    adv = it.advantages(end_state, params, end_key, roll)
    bufs, _ = it.update_buffers(roll, adv, end_key)
    moments = it.adv_moments(bufs)
    kslot, fields, _, _ = ppo_gather_inputs(base, cfg.num_species, None)
    held = [base.clone(), tstates]

    def env_steps():
        s = base.clone()
        for _ in range(PPO_T):
            s = env_mod.step(s, cfg)

    def whole():
        held[0], held[1], m = it(held[0], held[1], key)
        a2c.stack_metrics(m).cpu()

    parts = {
        "state_clone": base.clone,
        f"env_steps_{PPO_T}": env_steps,
        f"forwards_sampling_{PPO_T}": lambda: [it.policy_step(params, base, key)
                                               for _ in range(PPO_T)],
        f"pack_{PPO_T}": lambda: [it.pack_records(base, obs, action, logp, value)
                                  for _ in range(PPO_T)],
        "row_gather_kernel": lambda: row_gather_cuda.compact_fields(kslot, fields),
        "rollout": lambda: it.rollout(base.clone(), params, key),
        "bootstrap_gae": lambda: it.advantages(end_state, params, end_key, roll),
        "gae": lambda: ppo.gae(roll.reward, roll.alive, roll.next_alive, roll.value_full,
                               roll.value_full[0], it.gamma, it.gae_lambda),
        "buffers": lambda: it.update_buffers(roll, adv, end_key),
    }
    for s in range(cfg.num_species):
        parts[f"update_species_{s + 1}"] = (
            lambda s=s: it.updates(it.models[s], tstates[s], bufs[s], moments[s]))
    parts["metrics_copy"] = lambda: a2c.stack_metrics(run["metrics"]).cpu()
    parts["whole_iteration"] = whole
    ms = {name: host_ms(fn, reps=3) for name, fn in parts.items()}
    log(f"[where] ppo iteration host ms per call, synchronised: {json.dumps(ms)}")
    del roll, adv, bufs, moments

    launched, busy_ms, wall_ms, kern = traced(whole, 1)
    top = sorted(kern, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:8]
    log(f"[where] profiled ppo iteration: {launched:.0f} device kernels, device busy "
        f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall (idle share {1 - busy_ms / wall_ms:.3f}; "
        f"against the unprofiled whole_iteration {ms['whole_iteration']:.3f} ms: "
        f"{max(0.0, 1 - busy_ms / ms['whole_iteration']):.3f}); top by device time: "
        + "; ".join(f"{e.key[:48]} {getattr(e, 'self_device_time_total', 0.0) / 1e3:.3f} ms "
                    f"({e.count})" for e in top))


def where_the_time_goes(state, ray_inputs, cfg, actions) -> None:
    """Host-clock ms of each piece of a rollout tick, each call synchronised
    (the systems step on the kernel and on the plain path, each stepping its
    own clone of `state` in place), and a profiler trace of two whole ticks:
    kernels launched and device busy time."""
    from madrona_bots_tpu_torch.env import env as env_mod
    from madrona_bots_tpu_torch.learn.obs import construct_obs
    from madrona_bots_tpu_torch.ops import raycast_cuda, step_cuda

    s_k, s_p = state.clone(), state.clone()
    held = [state.clone()]

    def tick():
        held[0] = env_mod.shift_observations(
            env_mod.step(env_mod.set_actions(held[0], actions()), cfg), cfg)

    parts = {
        "actions": lambda: actions(),
        "step_systems": lambda: step_cuda.step_systems_cuda(s_k, cfg),
        "step_systems_plain": lambda: step_cuda.step_systems_plain(s_p, cfg),
        "raycast_kernel": lambda: raycast_cuda.raycast(*ray_inputs, cfg),
        "shift_observations": lambda: env_mod.shift_observations(s_k, cfg),
        "construct_obs": lambda: construct_obs(s_k, cfg),
        "whole_tick": tick,
    }
    ms = {name: host_ms(fn) for name, fn in parts.items()}
    log(f"[where] host ms per call, synchronised: {json.dumps(ms)}")
    del s_k, s_p

    launches, busy_ms, wall_ms, kern = traced(tick, 2)
    top = sorted(kern, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:6]
    log(f"[where] profiled tick: {launches:.0f} device kernels, device busy "
        f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall (idle share "
        f"{1 - busy_ms / wall_ms:.3f}; against the unprofiled whole_tick "
        f"{ms['whole_tick']:.3f} ms: {max(0.0, 1 - busy_ms / ms['whole_tick']):.3f}); top by "
        "device time: "
        + "; ".join(f"{e.key[:48]} {getattr(e, 'self_device_time_total', 0.0) / 2e3:.3f} ms"
                    f" ({e.count // 2} a tick)" for e in top))


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


MESH_STEPS, MESH_TICKS, MESH_TIMED = 8, 2, 4   # rollout steps, compared and timed ticks
MESH_RANKS, MESH_TIMEOUT_S = 2, 600
MESH_RTOL, MESH_ATOL = 1e-3, 1e-4             # tests/test_sharding.py's parameter tolerance
LEARNER_WRITTEN = ("action", "hidden")         # written by the last tick's updated policy
CLOCK_KEYS = ("_t", "epoch_fps")                # metrics that read the clock


def mesh_cli(flags: list, label: str) -> None:
    """[mesh] (a): the training CLI in this process at the bench shape, with
    and without --use_mesh (a group of one process, NCCL on the card): the
    checkpoints must equal in bits, the metrics rows too but their clock
    readings."""
    import glob
    import tempfile

    from madrona_bots_tpu_torch.learn import training_loop as cli
    from madrona_bots_tpu_torch.parallel import distributed

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        runs = {}
        for mode, extra in (("plain", []), ("mesh", ["--use_mesh"])):
            save = os.path.join(tmp, mode)
            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                cli.main(["--num_worlds", str(W), "--hidden_dim", str(HIDDEN), "--universe_id",
                          "mesh", "--model_save_dir", save, "--create_universe",
                          "--compute_dtype", "bf16"] + flags + extra + device_flag())
            names = sorted(os.path.relpath(f, save) for f in glob.glob(
                os.path.join(save, "**", "*"), recursive=True) if os.path.isfile(f))
            runs[mode] = (time.perf_counter() - t0, text.getvalue(), save, names)
        check("mesh: 1 devices, worlds sharded" in runs["mesh"][1], "CLI --use_mesh: no mesh line")
        check(runs["mesh"][3] == runs["plain"][3],
              f"CLI --use_mesh files {runs['mesh'][3]} vs {runs['plain'][3]}")
        bad, arrays = [], 0
        for name in runs["mesh"][3]:
            a, b = (os.path.join(runs[m][2], name) for m in ("mesh", "plain"))
            if name.endswith(".npz"):
                with np.load(a) as za, np.load(b) as zb:
                    arrays += len(za.files)
                    bad += [f"{name}:{k}" for k in za.files
                            if k not in zb.files or za[k].tobytes() != zb[k].tobytes()]
            else:
                rows = [[{k: v for k, v in json.loads(ln).items() if k not in CLOCK_KEYS}
                         for ln in open(p)] for p in (a, b)]
                if rows[0] != rows[1] or not rows[0]:
                    bad.append(name)
        check(not bad, f"CLI --use_mesh {label}: differs from the plain run in {bad[:8]}")
    log(f"[mesh] (a) CLI {label} ({' '.join(flags)}) at {W}x{A}, hidden {HIDDEN}, bf16: "
        f"--use_mesh (1 process, {distributed.choose_backend(torch.device(DEVICE), 1)}) "
        f"{runs['mesh'][0]:.1f} s, plain {runs['plain'][0]:.1f} s; {len(runs['mesh'][3])} files, "
        f"{arrays} checkpoint arrays equal in bits, metrics rows equal but {list(CLOCK_KEYS)}")


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def field_digests(state, worlds=None) -> dict:
    """blake2b of each field's bytes, of worlds [lo, hi) where given
    (`step_count` whole: it is replicated)."""
    from madrona_bots_tpu_torch.env.state import FIELDS
    out = {}
    for f in FIELDS:
        x = getattr(state, f)
        if worlds is not None and f != "step_count":
            x = x[worlds[0]:worlds[1]]
        out[f] = hashlib.blake2b(x.contiguous().cpu().numpy().tobytes(),
                                 digest_size=8).hexdigest()
    return out


def mesh_runs(mesh, dev, conf: dict, tag: str) -> dict:
    """[mesh] (b) on this process's worlds, with `mesh` (a rank's shard) or
    without (every world, the one-process reference): `steps` env steps
    with random one-hot actions drawn for every world, 2 A2C ticks (loop
    and stacked) and 1 PPO iteration, each from `init_state`, with each
    state's field digests (for every rank's slice without a mesh), the
    kernels' launches, the global count and dropped-row metrics, and the
    parameters saved to `{out}/{run}_{tag}.pt`; then timed ticks and a
    timed iteration."""
    import torch.nn.functional as F

    from madrona_bots_tpu_torch import EnvConfig, init_state, rng
    from madrona_bots_tpu_torch.env import env as env_mod
    from madrona_bots_tpu_torch.learn import a2c, ppo
    from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
    from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator

    Wn, bf16 = conf["worlds"], torch.bfloat16
    cfg = EnvConfig(num_worlds=Wn, init_agents=INIT, max_agents=A)
    worlds = None if mesh is None else mesh.world_range(Wn)
    lo, hi = worlds or (0, Wn)
    n = Wn // conf["ranks"]
    slices = ([None] if mesh is not None
              else [(r * n, (r + 1) * n) for r in range(conf["ranks"])])
    gen = SpeciesNetGenerator(cfg.obs_dim, 6, conf["hidden"], cfg.hidden_state_dim, seed=0)
    models = [ActorCritic.from_generator(gen, device=dev) for _ in range(cfg.num_species)]
    res = {"launches": {"systems": 0, "raycast": 0, "row_gather": 0}}

    def counted(fn):
        sync(dev)
        reset_launches()
        out = fn()
        sync(dev)
        for k, v in read_launches().items():
            res["launches"][k] += v
        return out, read_launches()

    def keep(name, state, ts, m, launches, units):
        tss = [ts] if isinstance(ts, a2c.SpeciesTrainState) else list(ts)
        leaves = [x for t in tss for x in (t.params, *t.opt_state)]
        torch.save({"params": [t.params.cpu() for t in tss],
                    "moments": [x.cpu() for t in tss for x in t.opt_state[1:]]},
                   os.path.join(conf["out"], f"{name}_{tag}.pt"))
        res[name] = {
            "fields": [field_digests(state, sl) for sl in slices],
            "launches": {k: v / units for k, v in launches.items()},
            "metrics": {k: float(v) for k, v in m.items() if k.endswith(("_count", "_dropped_rows"))},
            "params": hashlib.blake2b(b"".join(x.cpu().numpy().tobytes() for x in leaves),
                                      digest_size=8).hexdigest()}

    def rollout():
        s = init_state(cfg, 0, dev, worlds)
        for t in range(conf["steps"]):
            act = rng.randint(rng.fold_in(rng.key(77, dev), t), (Wn, A), 0, 6)[lo:hi]
            s = env_mod.shift_observations(env_mod.step(env_mod.set_actions(
                s, F.one_hot(act.long(), 6).to(torch.int32)), cfg), cfg)
        return s

    s, launches = counted(rollout)
    res["rollout"] = {"fields": [field_digests(s, sl) for sl in slices],
                      "launches": {k: v / conf["steps"] for k, v in launches.items()}}
    del s
    # bf16 (the bench shape's learners: timed), then f32 (held to the
    # strict tolerance: bf16 rounds each rank's gradient before the sum).
    for suffix, cd, timed in (("", bf16, conf["timed"]), ("_f32", None, 0)):
        for name, stacked in (("a2c" + suffix, False), ("a2c_stacked" + suffix, True)):
            tick, opt = a2c.make_train_tick(models, cfg, lr=LR, compute_dtype=cd,
                                            learner_slots_per_class=conf["rows"],
                                            stacked=stacked, mesh=mesh)
            init = a2c.init_stacked_train_state if stacked else a2c.init_train_states
            run = [init_state(cfg, 0, dev, worlds), init(models, rng.key(1, dev), opt), None]

            def ticks(k0, k1):
                for t in range(k0, k1):
                    run[0], run[1], run[2] = tick(run[0], run[1],
                                                  rng.fold_in(rng.key(9, dev), t))
                    a2c.stack_metrics(run[2]).cpu()

            _, launches = counted(lambda: ticks(0, MESH_TICKS))
            keep(name, run[0], run[1], run[2], launches, MESH_TICKS)
            times, calls = [], COLLECTIVES[0]
            for t in range(MESH_TICKS, MESH_TICKS + timed):
                sync(dev)
                t0 = time.perf_counter()
                ticks(t, t + 1)
                times.append((time.perf_counter() - t0) * 1e3)
            if timed:
                res[name].update(ms=float(np.median(times)),
                                 collectives=(COLLECTIVES[0] - calls) / timed)
        name = "ppo" + suffix
        it, opt = ppo.make_ppo_trainer(models, cfg, rollout_len=conf["ppo_t"],
                                       num_minibatches=conf["ppo_m"], lr=LR, compute_dtype=cd,
                                       learner_slots_per_class=conf["ppo_slots"], mesh=mesh)
        ts = a2c.init_train_states(models, rng.key(1, dev), opt)
        (s, ts, m), launches = counted(
            lambda: it(init_state(cfg, 2, dev, worlds), ts, rng.key(3, dev)))
        keep(name, s, ts, m, launches, 1)
        res[name]["losses"] = {k: float(v) for k, v in m.items() if k.endswith("_loss")}
        if timed:
            sync(dev)
            calls, t0 = COLLECTIVES[0], time.perf_counter()
            s, ts, m = it(s, ts, rng.key(4, dev))
            a2c.stack_metrics(m).cpu()
            res[name].update(ms=(time.perf_counter() - t0) * 1e3,
                             collectives=COLLECTIVES[0] - calls)
        del s, ts, m, it
    res["param_count"] = sum(mod.num_params for mod in models)
    return res


COLLECTIVES = [0]   # all-reduces this process made (counted in a mesh worker)


def mesh_worker(conf_json: str) -> int:
    """One rank of [mesh] (b), run as `chip_smoke.py --mesh-worker CONF`: a
    group of `ranks` processes through a file store (gloo on one card,
    NCCL with a card each), this rank's `mesh_runs`, and the all-reduce
    alone at the loop's gradient size and at the metric vector's; prints
    one JSON line."""
    import torch.distributed as dist

    from madrona_bots_tpu_torch.parallel import distributed

    conf = json.loads(conf_json)
    torch.backends.cuda.matmul.allow_tf32 = False        # as main(): f32 products in f32
    dev_arg = None if conf["device"] == "cuda" else conf["device"]
    mesh = distributed.initialize(f"file://{conf['store']}", conf["ranks"], conf["rank"],
                                  device=dev_arg, timeout_s=MESH_TIMEOUT_S / 2)
    plain_all_reduce = dist.all_reduce

    def counting_all_reduce(*args, **kwargs):
        COLLECTIVES[0] += 1
        return plain_all_reduce(*args, **kwargs)

    dist.all_reduce = counting_all_reduce
    try:
        res = mesh_runs(mesh, mesh.device, conf, f"rank{conf['rank']}")
        res.update(rank=mesh.rank, backend=dist.get_backend(), device=str(mesh.device),
                   worlds=list(mesh.world_range(conf["worlds"])))
        res["all_reduce_ms"] = {}
        for label, size in (("gradients", res["param_count"]), ("metrics", 60)):
            x = torch.ones(size, device=mesh.device)
            times = []
            for _ in range(21):
                sync(mesh.device)
                t0 = time.perf_counter()
                mesh.reduce_sum([x])
                sync(mesh.device)
                times.append((time.perf_counter() - t0) * 1e3)
            res["all_reduce_ms"][label] = float(np.median(times[1:]))
    finally:
        dist.all_reduce = plain_all_reduce
        distributed.shutdown()
    print(json.dumps(res), flush=True)
    return 0


def mesh_phase(dev, conf=None, cli: bool = True) -> dict:
    """[mesh]: (a) `mesh_cli` for A2C and PPO (with `cli`); (b) `mesh_runs`
    without a mesh over every world, then in `ranks` processes (default
    MESH_RANKS on this one card over gloo; `--mesh-cards N`: one a card
    over NCCL), each holding its share of the worlds: each rank's env shard
    equal in bits to its slice of the one-process run (after the A2C ticks
    but the fields the last tick's updated policy wrote), its parameters
    within MESH_RTOL / MESH_ATOL of the one-process run's and equal in bits
    across the ranks, its count and dropped-row metrics equal, one launch
    of each kernel a tick and PPO_T an iteration. Returns each kernel's
    launches by one rank over its counted runs."""
    import tempfile

    from madrona_bots_tpu_torch.parallel import distributed

    if cli:
        mesh_cli(["--learner_slots", str(ROWS), "--num_epochs", "3"], "a2c")
        mesh_cli(["--algo", "ppo", "--rollout_len", str(PPO_T), "--learner_slots",
                  str(PPO_SLOTS), "--num_epochs", "2"], "ppo")
    conf = dict(dict(worlds=W, hidden=HIDDEN, rows=ROWS, ppo_t=PPO_T, ppo_m=PPO_M,
                     ppo_slots=PPO_SLOTS, steps=MESH_STEPS, timed=MESH_TIMED, device=DEVICE,
                     ranks=MESH_RANKS), **(conf or {}))
    conf["backend"] = distributed.choose_backend(torch.device(DEVICE), conf["ranks"])
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        conf["out"], conf["store"] = tmp, os.path.join(tmp, "store")
        one = mesh_runs(None, dev, conf, "one")
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-worker",
                                   json.dumps(dict(conf, rank=r))],
                                  cwd=REPO, env=subprocess_env(), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(conf["ranks"])]
        outs = []
        try:
            for p in procs:
                try:
                    out, err = p.communicate(timeout=MESH_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    check(False, f"[mesh] a worker ran past {MESH_TIMEOUT_S} s")
                if p.returncode != 0:
                    log(err[-4000:])
                check(p.returncode == 0, f"[mesh] worker exited {p.returncode}")
                outs.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        report = mesh_report(one, outs, conf)
    return report


def mesh_report(one: dict, ranks: list, conf: dict) -> dict:
    """Hold the ranks' results against the one-process run and log them.
    Parameters of the f32 A2C ticks: within MESH_RTOL / MESH_ATOL everywhere
    (tests/test_sharding.py). The others by the port's bf16 rule
    (tests/test_torch_a2c.py, test_torch_ppo.py): within 2 lr per Adam step
    everywhere and under lr / 10 per step on average. In bf16 each rank
    rounds its gradient before the sum, so an element whose rank parts
    cancel may step the other way; in PPO a row whose ratio sits at the
    clip's edge may fall on either side when the forward's products round
    differently at another batch size, so its gradient is there or not.
    PPO is also held by its losses: f32 within 1e-4 relative
    (tests/test_multihost.py), bf16 within rtol 1e-2, atol 1e-3
    (tests/test_torch_ppo.py's bf16 metrics)."""
    pt = conf["ppo_t"]
    runs = {"rollout": ({"systems": 1, "raycast": 1, "row_gather": 0}, 1)}
    for suffix, gather in (("", 1), ("_f32", 0)):
        runs.update({"a2c" + suffix: ({"systems": 1, "raycast": 1, "row_gather": gather}, 2),
                     "a2c_stacked" + suffix: ({"systems": 1, "raycast": 1,
                                               "row_gather": gather}, 2),
                     "ppo" + suffix: ({"systems": pt, "raycast": pt, "row_gather": pt * gather},
                                      conf["ppo_m"])})
    R = len(ranks)
    for r, res in enumerate(ranks):
        check(res["worlds"] == [r * conf["worlds"] // R, (r + 1) * conf["worlds"] // R],
              f"rank {r} worlds")
        check(res["backend"] == conf["backend"], f"rank {r} backend {res['backend']}")
    for name, (launches, steps) in runs.items():
        diffs = []
        for r, res in enumerate(ranks):
            mine, ref = res[name]["fields"][0], one[name]["fields"][r]
            diffs.append(sorted(f for f in mine if mine[f] != ref[f]))
            check(res[name]["launches"] == launches,
                  f"[mesh] {name} rank {r} launches {res[name]['launches']}")
        allowed = LEARNER_WRITTEN if name.startswith("a2c") else ()
        check(all(set(d) <= set(allowed) for d in diffs),
              f"[mesh] {name}: shard fields differ from the one-process slice: {diffs}")
        unit = {"rollout": "step", "ppo": "iteration"}.get(name.split("_f32")[0], "tick")
        line = (f"[mesh] (b) {name}, {R} ranks: each rank's shard vs its slice of one process: fields "
                f"differing {diffs}; launches per {unit} {json.dumps(ranks[0][name]['launches'])}")
        if name != "rollout":
            check(all(res[name]["params"] == ranks[0][name]["params"] for res in ranks),
                  f"[mesh] {name}: parameters differ across ranks")
            for res in ranks:
                check(res[name]["metrics"] == one[name]["metrics"],
                      f"[mesh] {name}: count / dropped_rows {res[name]['metrics']} vs "
                      f"{one[name]['metrics']}")
            want = torch.load(os.path.join(conf["out"], f"{name}_one.pt"))
            got = torch.load(os.path.join(conf["out"], f"{name}_rank0.pt"))
            d = torch.cat([(g - w).abs() for g, w in zip(got["params"], want["params"])])
            outside = sum(int((~torch.isclose(g, w, rtol=MESH_RTOL, atol=MESH_ATOL)).sum())
                          for g, w in zip(got["params"], want["params"]))
            mom = max(float(((g - w).abs().max() / w.abs().max().clamp(min=1e-30)))
                      for g, w in zip(got["moments"], want["moments"]))
            if name.startswith("a2c") and name.endswith("_f32"):
                check(outside == 0, f"[mesh] {name}: {outside} parameters outside rtol "
                                    f"{MESH_RTOL}, atol {MESH_ATOL} (max |diff| {float(d.max())})")
            else:
                check(float(d.max()) <= 2 * LR * steps and float(d.mean()) <= LR / 10 * steps,
                      f"[mesh] {name}: parameters max |diff| {float(d.max())}, mean "
                      f"{float(d.mean())} over {steps} Adam steps")
            line += (f"; parameters equal across ranks ({ranks[0][name]['params']}), from one "
                     f"process max |diff| {float(d.max()):.3g}, mean {float(d.mean()):.3g}, "
                     f"{outside} of {d.numel()} outside rtol {MESH_RTOL}, atol {MESH_ATOL}; Adam "
                     f"moments max |diff| {mom:.3g} of max |moment|; count and dropped rows equal")
            if "ms" in ranks[0][name]:
                line += (f"; ms one process {one[name]['ms']:.3f} vs ranks "
                         + " / ".join(f"{res[name]['ms']:.3f}" for res in ranks)
                         + f" ({ranks[0][name]['collectives']:.0f} all-reduces)")
        if name.startswith("ppo"):
            pairs = [(res[name]["losses"][k], v) for res in ranks
                     for k, v in one[name]["losses"].items()]
            rel = max(abs(a - b) / max(1.0, abs(b)) for a, b in pairs)
            # f32: tests/test_multihost.py's rule; bf16: the bf16 metric
            # tolerance of tests/test_torch_ppo.py (rtol 1e-2, atol 1e-3).
            check(rel < 1e-4 if name.endswith("_f32")
                  else all(abs(a - b) <= 1e-3 + 1e-2 * abs(b) for a, b in pairs),
                  f"[mesh] {name}: losses {rel} relative from one process")
            line += f"; losses within {rel:.3g} relative"
        log(line)
    log(f"[mesh] (b) all-reduce alone over {conf['backend']}, {R} ranks, ms median of 20: "
        + "; ".join(f"rank {res['rank']} {json.dumps(res['all_reduce_ms'])}" for res in ranks)
        + f" (gradients: {one['param_count']} f32, the loop's four species)")
    return ranks[0]["launches"]


LCURVE_A2C = dict(worlds=2048, block=8)      # lcurve_seeds.py's width; 2 blocks of 8 epochs
LCURVE_PPO = dict(worlds=W, block=2)         # ppo_multiseed_r5.py's; 2 blocks of 2 iterations


def lcurve_phase(dev, smi: str) -> dict:
    """[lcurve]: each driver straight for 2 blocks with the launches
    counted, then 1 block, a resume point, a new driver resuming from it
    and 1 block: equal in bits to the straight run (series, parameters,
    Adam state, world state). Returns each kernel's launches over the two
    straight runs."""
    from madrona_bots_tpu_torch.env.state import FIELDS
    from madrona_bots_tpu_torch.tools import lcurve

    root = os.path.join(REPO, "build", "lcurve_smoke")
    shutil.rmtree(root, ignore_errors=True)
    total = {"systems": 0, "raycast": 0, "row_gather": 0}
    specs = (lcurve.a2c_spec("raw_logit", 0, epochs=2 * LCURVE_A2C["block"], **LCURVE_A2C),
             lcurve.ppo_spec(0, iters=2 * LCURVE_PPO["block"], **LCURVE_PPO))
    for spec in specs:
        ppo = spec.algo == "ppo"
        torch.cuda.synchronize()
        reset_launches()
        straight = lcurve.Driver(spec, dev).start()
        straight.advance()
        torch.cuda.synchronize()
        launches = read_launches()
        per = spec.steps * (spec.rollout if ppo else 1)
        check(launches == {"systems": per, "raycast": per, "row_gather": per},
              f"[lcurve] {spec.name}: launches {launches}, want {per} each")
        for k, v in launches.items():
            total[k] += v
        t0 = time.perf_counter()
        first = lcurve.Driver(spec, dev, root).start()
        first.advance(max_blocks=1)
        del first
        resumed = lcurve.Driver(spec, dev, root).start()
        t_resume = time.perf_counter() - t0
        check(resumed.next_block == 1 and resumed.calls == 2,
              f"[lcurve] {spec.name}: resumed at block {resumed.next_block}")
        resumed.advance()
        torch.cuda.synchronize()
        bad = []
        if straight.series.tobytes() != resumed.series.tobytes():
            bad.append("series")
        for i, (a, b) in enumerate(zip(straight.train_states, resumed.train_states)):
            for name, x, y in (("params", a.params, b.params), ("mu", a.opt_state.mu,
                               b.opt_state.mu), ("nu", a.opt_state.nu, b.opt_state.nu),
                               ("count", a.opt_state.count, b.opt_state.count)):
                if x.cpu().numpy().tobytes() != y.cpu().numpy().tobytes():
                    bad.append(f"species {i + 1} {name}")
        for f in FIELDS:
            if (getattr(straight.state, f).cpu().numpy().tobytes()
                    != getattr(resumed.state, f).cpu().numpy().tobytes()):
                bad.append(f)
        finite = bool(np.isfinite(straight.series).all())
        steps_s = spec.steps / straight.seconds
        env_s = spec.steps * (spec.rollout if ppo else 1) * spec.worlds / straight.seconds
        unit = "iterations" if ppo else "epochs"
        log(f"[lcurve] {spec.name}: {spec.steps // spec.block} blocks of {spec.block} {unit} "
            f"straight at {spec.worlds} worlds: {steps_s:.2f} {unit}/s, {env_s:.1f} "
            f"env-steps/s (host clock, first block included) on {smi}; launches "
            f"{json.dumps(launches)}; 1 + resume + 1 ({t_resume:.1f} s to write, drop and "
            f"reload the point) vs straight: {len(bad)} fields differ in bits "
            f"{bad[:8]}; series finite {finite}")
        check(not bad, f"[lcurve] {spec.name}: resumed differs from straight in {bad}")
        check(finite, f"[lcurve] {spec.name}: series not finite")
        del straight, resumed
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return total


def lcurve_only() -> int:
    """`chip_smoke.py --lcurve`: [build] and [lcurve] alone."""
    if not torch.cuda.is_available():
        print("chip_smoke --lcurve: no CUDA device", file=sys.stderr)
        return 1
    from madrona_bots_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = name_and_power()[0]
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[build] in {_build.build()[0]:.1f} s")
    launches = lcurve_phase(torch.device(DEVICE), smi)
    log(f"[lcurve] launches in the two straight runs: {json.dumps(launches)}")
    return 0


def mesh_cards(n: int) -> int:
    """`chip_smoke.py --mesh-cards N`: [mesh] (b) alone, one process a card
    on N cards (NCCL), against one process on the first card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"chip_smoke --mesh-cards {n}: needs {n} CUDA devices", file=sys.stderr)
        return 1
    from madrona_bots_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = name_and_power()
    log(f"devices: {'; '.join(smi)} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[build] in {_build.build()[0]:.1f} s")
    launches = mesh_phase(torch.device(DEVICE), conf=dict(ranks=n), cli=False)
    log(f"[mesh] launches by one rank in its counted runs: {json.dumps(launches)}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-cards"]:
        sys.exit(mesh_cards(int(sys.argv[2])))
    if sys.argv[1:2] == ["--lcurve"]:
        sys.exit(lcurve_only())
    sys.exit(main())
