"""Learning-curve drivers with chunked, bit-exact resume, and the band check.

Counterparts of the JAX package's band drivers, `artifacts/lcurve_seeds.py`
(A2C) and `artifacts/ppo_multiseed_r5.py` (PPO), on the port:

* `a2c`: the fused A2C tick at the reference configuration (2048 worlds x
  32 initial agents, max 128, reward setting 8, quirk_compat, bf16, 12
  learner slots a class, hidden 128), one objective (raw-logit or
  proper_log_probs) a run, 3,200 epochs in blocks of 160; the 16 series
  `species_{1..4}_{avg_action_entropy,count_per_world,reward,avg_health}`,
  kept every 20th epoch in the row.
* `ppo`: PPO at 8192 worlds, bf16, rollout 16, 1 x 8, 8 (or 12) learner
  slots, 1,500 iterations in blocks of 25; `species_{i}_{entropy,reward,
  count,loss}` and `dropped`, kept every 10th iteration, and the tail-200
  means.

Block b runs under `fold_in(key(seed), b)` split into one key an epoch
(iteration), the JAX scripts' stream. A block's metrics stay on the device
and leave it in one copy at the block's end.

Resume: after each block the run's resume point (the sim state through
`learn/ckpt.save_sim_state`, every species' parameters and Adam state, the
next block, the full-rate series and the timing sums) is written to
`<resume-dir>/<run>/tmp-<pid>` and renamed to `<resume-dir>/<run>/b<next>`.
`--max-seconds` ends a call at a block boundary (exit code 75); the next
call with the same arguments resumes from the newest point, and a resumed
run equals an uninterrupted one in every bit of its series and parameters.
A finished run appends its row to `--out` once (rows carry their `run`
name, and a run whose row is there is not written again) and then deletes
its points.

`bands` reads the JAX records and the port's rows and applies the JAX
scripts' own statistics and the rule in `rule`.

    python -m madrona_bots_tpu_torch.tools.lcurve a2c --objective raw_logit \
        --seeds 0 1 2 3 4 --procs 5
    python -m madrona_bots_tpu_torch.tools.lcurve ppo --slots 8 --seeds 0 1 2 --procs 3
    python -m madrona_bots_tpu_torch.tools.lcurve bands
    python -m madrona_bots_tpu_torch.tools.lcurve a2c --objective proper --seeds 0 \
        --worlds 8 --epochs 8 --block 4 --hidden 32 --device cpu --out /tmp/a2c.jsonl

The drivers run on CUDA unless `--device` names another device; without a
card they raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import fcntl
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.device import resolve
from madrona_bots_tpu_torch.env.state import init_state
from madrona_bots_tpu_torch.learn import a2c, ppo
from madrona_bots_tpu_torch.learn.ckpt import load_sim_state, save_sim_state
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator

f32 = torch.float32
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NS = 4
A2C_KEEP = ("avg_action_entropy", "count_per_world", "reward", "avg_health")
PPO_KEEP = ("entropy", "reward", "count", "loss")
A2C_OBJECTIVES = ("raw_logit", "proper")
JAX_A2C = os.path.join(REPO, "artifacts", "lcurve", "multiseed_r3.jsonl")
JAX_PPO = os.path.join(REPO, "artifacts", "lcurve", "ppo_multiseed_r5.jsonl")
PORT_A2C = os.path.join(REPO, "artifacts", "lcurve", "torch_multiseed_a2c.jsonl")
PORT_PPO = os.path.join(REPO, "artifacts", "lcurve", "torch_ppo_multiseed.jsonl")
RESUME_DIR = os.path.join(REPO, "build", "lcurve")
STOPPED = 75
"""Exit code of a call that stopped at its `--max-seconds` budget with a
resume point written (EX_TEMPFAIL)."""


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One learning-curve run. `steps` are A2C epochs or PPO iterations;
    `objective` is `raw_logit` / `proper` for A2C and `ppo` for PPO."""

    objective: str
    seed: int
    steps: int
    worlds: int
    block: int
    slots: int
    hidden: int = 128
    dtype: str = "bf16"
    rollout: int = 16

    @property
    def algo(self) -> str:
        return "ppo" if self.objective == "ppo" else "a2c"

    @property
    def name(self) -> str:
        tail = f"_t{self.rollout}" if self.algo == "ppo" else ""
        return (f"{self.objective}_s{self.seed}_w{self.worlds}_n{self.steps}_b{self.block}"
                f"_l{self.slots}_h{self.hidden}_{self.dtype}{tail}")

    def series_names(self) -> list:
        keep = PPO_KEEP if self.algo == "ppo" else A2C_KEEP
        names = [f"species_{i}_{n}" for i in range(1, NS + 1) for n in keep]
        return names + ["dropped"] if self.algo == "ppo" else names


def a2c_spec(objective: str, seed: int, epochs: int = 3200, worlds: int = 2048,
             block: int = 160, slots: int = 12, hidden: int = 128,
             dtype: str = "bf16") -> RunSpec:
    if objective not in A2C_OBJECTIVES:
        raise ValueError(f"objective {objective!r} is not one of {A2C_OBJECTIVES}")
    return RunSpec(objective, seed, epochs, worlds, block, slots, hidden, dtype)


def ppo_spec(seed: int, slots: int = 8, iters: int = 1500, worlds: int = 8192,
             block: int = 25, hidden: int = 128, dtype: str = "bf16",
             rollout: int = 16) -> RunSpec:
    return RunSpec("ppo", seed, iters, worlds, block, slots, hidden, dtype, rollout)


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    device's type off the card."""
    if dev.type != "cuda":
        return dev.type
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    lines = out.stdout.strip().splitlines()
    return lines[min(dev.index or 0, len(lines) - 1)] if lines else torch.cuda.get_device_name(dev)


class Driver:
    """A run's models, learner and state, advanced a block at a time.

    `start()` builds everything and loads the newest resume point under
    `resume_dir` (if any); `advance()` runs blocks, writing a point after
    each when `resume_dir` is set; `row()` is the finished run's output
    row. With a mesh-free learner on `device`, the whole run is a pure
    function of the spec, so its bits do not depend on where it stopped."""

    def __init__(self, spec: RunSpec, device=None, resume_dir: str | None = None):
        self.spec = spec
        self.dev = resolve(device)
        self.point_root = None if resume_dir is None else os.path.join(resume_dir, spec.name)
        self.names = spec.series_names()

    # ---- set-up ----

    def start(self) -> "Driver":
        s, dev = self.spec, self.dev
        cd = {"bf16": torch.bfloat16, "f32": None}[s.dtype]
        cfg = EnvConfig(num_worlds=s.worlds, init_agents=32, max_agents=128)
        gen = SpeciesNetGenerator(cfg.obs_dim, 6, s.hidden, cfg.hidden_state_dim, seed=s.seed)
        self.models = [ActorCritic.from_generator(gen, device=dev) for _ in range(NS)]
        if s.algo == "ppo":
            self.tick, opt = ppo.make_ppo_trainer(
                self.models, cfg, rollout_len=s.rollout, use_kernels=True, compute_dtype=cd,
                learner_slots_per_class=s.slots)
        else:
            self.tick, opt = a2c.make_train_tick(
                self.models, cfg, proper_log_probs=s.objective == "proper", quirk_compat=True,
                use_kernels=True, compute_dtype=cd, learner_slots_per_class=s.slots)
        self.next_block, self.series = 0, np.zeros((0, len(self.names)), np.float32)
        self.seconds, self.rate_seconds, self.calls = 0.0, 0.0, 0
        point = self.newest_point()
        if point is None:
            self.train_states = a2c.init_train_states(self.models, rng.key(s.seed, dev), opt)
            self.state = init_state(cfg, seed=s.seed + 1000, device=dev)
        else:
            self.load_point(point)
        self.calls += 1
        return self

    @property
    def num_blocks(self) -> int:
        return self.spec.steps // self.spec.block

    @property
    def done(self) -> bool:
        return self.next_block >= self.num_blocks

    # ---- running ----

    def metrics_row(self, m: dict) -> torch.Tensor:
        """The kept series of one epoch (iteration) as one f32 vector on the
        device."""
        vals = [m[n].to(f32) for n in self.names if n != "dropped"]
        if self.spec.algo == "ppo":
            vals.append(sum(m[f"species_{i}_dropped_rows"].to(f32) for i in range(1, NS + 1)))
        return torch.stack(vals)

    def run_block(self) -> None:
        b, s = self.next_block, self.spec
        t0 = time.perf_counter()
        keys = rng.split(rng.fold_in(rng.key(s.seed, self.dev), b), s.block)
        rows = []
        for e in range(s.block):
            self.state, self.train_states, m = self.tick(self.state, self.train_states, keys[e])
            rows.append(self.metrics_row(m))
        host = torch.stack(rows).cpu().numpy()          # the block's one copy (a sync)
        dt = time.perf_counter() - t0
        self.series = np.concatenate([self.series, host])
        self.seconds += dt
        if b > 0:
            self.rate_seconds += dt
        self.next_block = b + 1

    def advance(self, max_seconds: float | None = None, max_blocks: int | None = None,
                started: float | None = None) -> bool:
        """Run blocks until the run is done, `max_blocks` have run, or the
        next block would end past `max_seconds` after `started` (default:
        now; the longest block of this call is the estimate, and the first
        block always runs). Writes a resume point after each block. True
        when the run is done."""
        started = time.perf_counter() if started is None else started
        longest, ran = 0.0, 0
        while not self.done:
            if max_blocks is not None and ran >= max_blocks:
                break
            if (max_seconds is not None and ran > 0
                    and time.perf_counter() - started + longest > max_seconds):
                break
            t0 = time.perf_counter()
            self.run_block()
            if self.point_root is not None:
                self.save_point()
            longest = max(longest, time.perf_counter() - t0)
            ran += 1
        return self.done

    # ---- resume points ----

    def newest_point(self) -> str | None:
        if self.point_root is None or not os.path.isdir(self.point_root):
            return None
        points = sorted(d for d in os.listdir(self.point_root)
                        if d.startswith("b") and d[1:].isdigit())
        return os.path.join(self.point_root, points[-1]) if points else None

    def save_point(self) -> str:
        """Write the resume point under a temporary name, rename it to
        `b<next block>`, then delete the older points."""
        os.makedirs(self.point_root, exist_ok=True)
        tmp = os.path.join(self.point_root, f"tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_sim_state(self.state, os.path.join(tmp, "state.npz"))
        arrays = {}
        for i, ts in enumerate(self.train_states):
            arrays[f"params_{i}"] = ts.params.detach().cpu().numpy()
            arrays[f"count_{i}"] = ts.opt_state.count.cpu().numpy()
            arrays[f"mu_{i}"] = ts.opt_state.mu.cpu().numpy()
            arrays[f"nu_{i}"] = ts.opt_state.nu.cpu().numpy()
        np.savez(os.path.join(tmp, "train.npz"), series=self.series, **arrays)
        with open(os.path.join(tmp, "progress.json"), "w") as f:
            json.dump({"spec": dataclasses.asdict(self.spec), "next_block": self.next_block,
                       "seconds": self.seconds, "rate_seconds": self.rate_seconds,
                       "calls": self.calls}, f)
        final = os.path.join(self.point_root, f"b{self.next_block:06d}")
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        for d in os.listdir(self.point_root):
            if d.startswith("b") and d < os.path.basename(final):
                shutil.rmtree(os.path.join(self.point_root, d), ignore_errors=True)
        return final

    def load_point(self, point: str) -> None:
        with open(os.path.join(point, "progress.json")) as f:
            prog = json.load(f)
        if prog["spec"] != dataclasses.asdict(self.spec):
            raise ValueError(f"{point} holds the run {prog['spec']}, not {self.spec}")
        self.state = load_sim_state(os.path.join(point, "state.npz"), self.dev)
        with np.load(os.path.join(point, "train.npz")) as z:
            self.series = np.array(z["series"], dtype=np.float32)
            self.train_states = tuple(
                a2c.SpeciesTrainState(
                    torch.from_numpy(z[f"params_{i}"]).to(self.dev),
                    a2c.AdamState(torch.from_numpy(z[f"count_{i}"]).to(self.dev),
                                  torch.from_numpy(z[f"mu_{i}"]).to(self.dev),
                                  torch.from_numpy(z[f"nu_{i}"]).to(self.dev)))
                for i in range(NS))
        self.next_block = prog["next_block"]
        self.seconds, self.rate_seconds = prog["seconds"], prog["rate_seconds"]
        self.calls = prog["calls"]

    def clear_points(self) -> None:
        if self.point_root is not None:
            shutil.rmtree(self.point_root, ignore_errors=True)

    # ---- output ----

    def series_dict(self) -> dict:
        return {n: self.series[:, j] for j, n in enumerate(self.names)}

    def row(self, device: str, shared_card: int) -> dict:
        """The finished run's row in the JAX script's schema, plus `run`,
        `compute_dtype`, `device`, `shared_card` and `calls`."""
        s = self.spec
        series = self.series_dict()
        extra = {"run": s.name, "compute_dtype": s.dtype, "hidden": s.hidden,
                 "device": device, "shared_card": shared_card, "calls": self.calls}
        if s.algo == "a2c":
            out = {k: v[::20].astype(float).round(4).tolist() for k, v in series.items()}
            return {"objective": s.objective, "seed": s.seed, "epochs": s.steps,
                    "worlds": s.worlds, "fps": round(s.steps * s.worlds / self.seconds, 1),
                    "series_every": 20, "series": out, "learner_slots": s.slots, **extra}
        tail = {n: float(np.mean([series[f"species_{i}_{n}"][-200:]
                                  for i in range(1, NS + 1)])) for n in PPO_KEEP}
        rate = ((s.steps - s.block) * s.rollout * s.worlds / self.rate_seconds
                if self.rate_seconds > 0 else None)
        out = {k: v[::10].astype(float).round(4).tolist() for k, v in series.items()}
        return {"slots": s.slots, "seed": s.seed, "iters": s.steps, "worlds": s.worlds,
                "rollout_len": s.rollout,
                "env_steps_per_s": None if rate is None else round(rate, 1),
                "tail200_mean": tail, "series_every": 10, "series": out, **extra}


def read_rows(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def append_row(path: str, row: dict) -> bool:
    """Append `row` unless a row of the same run is in the file already
    (under a lock, so that concurrent runs may share the file). True when
    it was written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            f.seek(0)
            if any(json.loads(line).get("run") == row["run"] for line in f if line.strip()):
                return False
            f.write(json.dumps(row) + "\n")
            f.flush()
            return True
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def run(spec: RunSpec, out: str, device=None, resume_dir: str | None = RESUME_DIR,
        max_seconds: float | None = None, shared_card: int = 1) -> dict | None:
    """Run (or resume) one run to its end or its budget. Returns its row
    once it is finished (appended to `out` unless the run's row is there
    already), None when it stopped at the budget with a resume point."""
    started = time.perf_counter()
    done = [r for r in read_rows(out) if r.get("run") == spec.name]
    if done:
        print(f"{spec.name}: its row is in {out} already", flush=True)
        return done[0]
    drv = Driver(spec, device, resume_dir).start()
    print(f"{spec.name}: block {drv.next_block} of {drv.num_blocks}, call {drv.calls}",
          flush=True)
    if not drv.advance(max_seconds, started=started):
        print(f"{spec.name}: stopped at block {drv.next_block} of {drv.num_blocks} "
              f"({drv.seconds:.1f} s of blocks so far)", flush=True)
        return None
    row = drv.row(device_label(drv.dev), shared_card)
    written = append_row(out, row)
    drv.clear_points()
    rate = (f"{row['fps']} epochs x worlds / s" if spec.algo == "a2c"
            else f"{row['env_steps_per_s']} env-steps/s")
    kept = "" if written else "; its row was there already"
    print(f"{spec.name}: done in {drv.calls} call(s), {drv.seconds:.1f} s of blocks, {rate} "
          f"({row['device']}, {shared_card} driver(s) on the device){kept}", flush=True)
    return row


# ---- bands ----

def stats(values) -> dict:
    v = np.asarray(values, dtype=np.float64)
    return {"n": int(v.size), "mean": float(np.mean(v)), "sd": float(np.std(v)),
            "min": float(np.min(v)), "max": float(np.max(v)), "values": v.tolist()}


def a2c_finals(rows: list, objective: str, metric: str) -> list:
    """`lcurve_seeds.py`'s statistic: each seed's last downsampled point,
    averaged over the 4 species."""
    return [float(np.mean([r["series"][f"species_{i}_{metric}"][-1] for i in range(1, NS + 1)]))
            for r in rows if r["objective"] == objective]


def ppo_finals(rows: list, metric: str, slots: int = 8) -> list:
    """`ppo_multiseed_r5.py`'s statistic: each seed's tail-200 mean."""
    return [r["tail200_mean"][metric] for r in rows
            if r.get("kind") != "summary" and r["slots"] == slots]


def rule(jax_band: dict, port_band: dict) -> dict:
    """In when |mean_port - mean_jax| <= max(2 * sqrt(sd_jax^2 / n_jax +
    sd_port^2 / n_port), 1e-3 * |mean_jax|); also how many port values fall
    inside the JAX [min, max]."""
    tol = max(2.0 * math.sqrt(jax_band["sd"] ** 2 / jax_band["n"]
                              + port_band["sd"] ** 2 / port_band["n"]),
              1e-3 * abs(jax_band["mean"]))
    diff = port_band["mean"] - jax_band["mean"]
    inside = sum(jax_band["min"] <= v <= jax_band["max"] for v in port_band["values"])
    return {"diff": diff, "tol": tol, "in": abs(diff) <= tol, "seeds_in_range": inside}


def reference_rows(rows: list, jax_rows: list, keys: tuple) -> list:
    """The port rows run at the JAX rows' configuration (`keys` equal)."""
    conf = {tuple(r[k] for k in keys) for r in jax_rows if r.get("kind") != "summary"}
    return [r for r in rows if tuple(r.get(k) for k in keys) in conf]


def window_means(rows: list, metric: str, window: int) -> np.ndarray:
    """Each row's curve (its kept series, mean over species) averaged over
    consecutive windows of `window` epochs (iterations): [rows, windows]."""
    out = []
    for r in rows:
        curve = np.mean([r["series"][f"species_{i}_{metric}"] for i in range(1, NS + 1)], axis=0)
        k = max(1, window // r["series_every"])
        n = len(curve) // k
        out.append(curve[:n * k].reshape(n, k).mean(axis=1))
    return np.array(out)


def parting(jax_w: np.ndarray, port_w: np.ndarray) -> list:
    """The windows where the port seeds' mean lies outside the JAX seeds'
    [min, max] (`window_means` of each)."""
    n = min(jax_w.shape[1], port_w.shape[1])
    pm, j = port_w[:, :n].mean(axis=0), jax_w[:, :n]
    return [int(i) for i in np.flatnonzero((pm < j.min(axis=0)) | (pm > j.max(axis=0)))]


def compare(jax_a2c: list, jax_ppo: list, port_a2c: list, port_ppo: list,
            window: int | None = None) -> list:
    """Every (objective, metric) comparison: the JAX band, the port band
    (None without port rows) and the rule's verdict; PPO also the slots-12
    control value of each package. With `window` also each seed's
    `window_means` and `outside`, the first epoch (iteration) of each
    window of that length where the curves part (`parting`)."""
    out = []
    port_a2c = reference_rows(port_a2c, jax_a2c, ("epochs", "worlds"))
    port_ppo = reference_rows(port_ppo, jax_ppo, ("iters", "worlds", "rollout_len"))
    for obj in A2C_OBJECTIVES:
        for metric in A2C_KEEP:
            out.append({"objective": obj, "metric": metric,
                        "jax": stats(a2c_finals(jax_a2c, obj, metric)),
                        "port": a2c_finals(port_a2c, obj, metric),
                        "rows": [[r for r in rows if r["objective"] == obj]
                                 for rows in (jax_a2c, port_a2c)]})
    for metric in PPO_KEEP:
        ctrl_j, ctrl_p = ppo_finals(jax_ppo, metric, 12), ppo_finals(port_ppo, metric, 12)
        out.append({"objective": "ppo_slots8", "metric": metric,
                    "jax": stats(ppo_finals(jax_ppo, metric)),
                    "port": ppo_finals(port_ppo, metric),
                    "control_slots12": {"jax": ctrl_j[0] if ctrl_j else None,
                                        "port": ctrl_p[0] if ctrl_p else None},
                    "rows": [[r for r in rows if r.get("kind") != "summary" and r["slots"] == 8]
                             for rows in (jax_ppo, port_ppo)]})
    for c in out:
        jax_rows, port_rows = c.pop("rows")
        c["port"] = stats(c["port"]) if c["port"] else None
        c.update(rule(c["jax"], c["port"]) if c["port"] else
                 {"diff": None, "tol": None, "in": None, "seeds_in_range": None})
        if window is not None and port_rows:
            jw = window_means(jax_rows, c["metric"], window)
            pw = window_means(port_rows, c["metric"], window)
            c["outside"] = [w * window for w in parting(jw, pw)]
            c["window_means"] = {"jax": jw.tolist(), "port": pw.tolist()}
    return out


def format_band(b: dict | None) -> str:
    if b is None:
        return "not run"
    return f"{b['mean']:.4f} ± {b['sd']:.4f} [{b['min']:.4f}..{b['max']:.4f}] (n {b['n']})"


def print_bands(comps: list, window: int | None = None) -> None:
    for c in comps:
        verdict = ("not run" if c["in"] is None else
                   f"{'in' if c['in'] else 'MISS'} (|diff| {abs(c['diff']):.4g} vs "
                   f"{c['tol']:.4g}; {c['seeds_in_range']} of {c['port']['n']} port seeds "
                   f"in the JAX range)")
        ctrl = c.get("control_slots12")
        ctrl = ("" if ctrl is None else
                f"; slots 12 control: JAX {ctrl['jax']}, port {ctrl['port']}")
        if "outside" in c:
            ctrl += (f"; windows of {window} (first step) with the port seeds' mean outside "
                     f"the JAX seeds' range: {c['outside']}")
        print(f"{c['objective']:10s} {c['metric']:20s} JAX {format_band(c['jax'])} | port "
              f"{format_band(c['port'])} | {verdict}{ctrl}", flush=True)


# ---- command line ----

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    for algo in ("a2c", "ppo"):
        q = sub.add_parser(algo, help=f"{algo.upper()} learning-curve runs")
        if algo == "a2c":
            q.add_argument("--objective", choices=A2C_OBJECTIVES, required=True)
            q.add_argument("--epochs", type=int, default=3200)
            q.add_argument("--worlds", type=int, default=2048)
            q.add_argument("--block", type=int, default=160)
        else:
            q.add_argument("--iters", type=int, default=1500)
            q.add_argument("--worlds", type=int, default=8192)
            q.add_argument("--block", type=int, default=25)
            q.add_argument("--slots", type=int, default=8)
        q.add_argument("--seeds", type=int, nargs="+", default=[0])
        q.add_argument("--hidden", type=int, default=128)
        q.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
        q.add_argument("--out", default=PORT_PPO if algo == "ppo" else PORT_A2C)
        q.add_argument("--resume-dir", default=RESUME_DIR)
        q.add_argument("--max-seconds", type=float, default=None,
                       help="end the call at the first block boundary past this budget "
                            "(exit code 75); the same command resumes")
        q.add_argument("--procs", type=int, default=1,
                       help="runs at once, one process each, on the one device")
        q.add_argument("--shared-card", type=int, default=None,
                       help="driver processes sharing the device, for the rows (default: "
                            "this call's own)")
        q.add_argument("--device", default=None,
                       help="torch device; default CUDA (raises without a card)")
    q = sub.add_parser("bands", help="the port's rows against the JAX records")
    q.add_argument("--jax-a2c", default=JAX_A2C)
    q.add_argument("--jax-ppo", default=JAX_PPO)
    q.add_argument("--port-a2c", default=PORT_A2C)
    q.add_argument("--port-ppo", default=PORT_PPO)
    q.add_argument("--window", type=int, default=None,
                   help="also list the windows of this many epochs (iterations) where the "
                        "port seeds' mean curve lies outside the JAX seeds' range")
    q.add_argument("--json", action="store_true", help="print the comparisons as JSON")
    return p


def specs_of(args) -> list:
    if args.cmd == "a2c":
        return [a2c_spec(args.objective, s, args.epochs, args.worlds, args.block,
                         hidden=args.hidden, dtype=args.dtype) for s in args.seeds]
    return [ppo_spec(s, args.slots, args.iters, args.worlds, args.block, args.hidden, args.dtype)
            for s in args.seeds]


def worker_argv(argv: list, seed: int, shared: int) -> list:
    """`argv` with `--seeds` cut to one seed and `--procs 1`."""
    out, i = [], 0
    while i < len(argv):
        if argv[i] in ("--seeds", "--procs", "--shared-card"):
            i += 1
            while i < len(argv) and not argv[i].startswith("--"):
                i += 1
            continue
        out.append(argv[i])
        i += 1
    return out + ["--seeds", str(seed), "--procs", "1", "--shared-card", str(shared)]


def run_procs(args, argv: list) -> int:
    """Every seed in its own process, `--procs` at a time; 0 when every run
    finished, 75 when one stopped at its budget."""
    dev = resolve(args.device)
    if dev.type == "cuda":
        from madrona_bots_tpu_torch.ops import _build
        _build.build()                   # once, before the workers load the libraries
    procs = min(args.procs, len(args.seeds))
    shared = args.shared_card or procs
    pending, live, rcs = list(args.seeds), [], []
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // shared)))
    while pending or live:
        while pending and len(live) < procs:
            seed = pending.pop(0)
            live.append(subprocess.Popen(
                [sys.executable, "-m", "madrona_bots_tpu_torch.tools.lcurve",
                 *worker_argv(argv, seed, shared)], cwd=REPO, env=env))
        time.sleep(0.5)
        for p in [p for p in live if p.poll() is not None]:
            rcs.append(p.returncode)
            live.remove(p)
    if any(rc not in (0, STOPPED) for rc in rcs):
        return 1
    return STOPPED if STOPPED in rcs else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.cmd == "bands":
        comps = compare(read_rows(args.jax_a2c), read_rows(args.jax_ppo),
                        read_rows(args.port_a2c), read_rows(args.port_ppo), args.window)
        if args.json:
            print(json.dumps(comps))
        else:
            print_bands(comps, args.window)
        return 0
    if args.procs > 1 and len(args.seeds) > 1:
        return run_procs(args, argv)
    shared = args.shared_card or 1
    started, stopped = time.perf_counter(), False
    for n, spec in enumerate(specs_of(args)):
        left = None if args.max_seconds is None else args.max_seconds - (
            time.perf_counter() - started)
        if n > 0 and left is not None and left <= 0:     # the first run makes progress
            stopped = True
            continue
        stopped |= run(spec, args.out, args.device, args.resume_dir, left, shared) is None
    return STOPPED if stopped else 0


if __name__ == "__main__":
    sys.exit(main())
