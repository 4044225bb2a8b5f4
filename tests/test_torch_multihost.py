"""Two processes of the port in one gloo group (a file store under the
test's directory, no TCP port), each holding 4 of 8 worlds, against one
process: a 10-step env trajectory and a PPO iteration whose env checksums
(tests/test_multihost.py's `_csum` rule: wrapping int32 sums of every
field's values, floats as their bits, world keys left out) equal the port's
single-process ones in bits, and the JAX package's over every field the
port holds in bits against JAX (tests/test_torch_ppo.py): all but the
`surrounding` fields (SPEC D10, within ulps) and, after PPO, the policy's
`hidden` memory (XLA:CPU's tanh); PPO losses within
1e-4 relative of JAX's; two A2C ticks
(learner slots with quirks, and stacked) with parameters at
tests/test_sharding.py's tolerance of the port's single-process ticks, and
a 2-epoch CLI run with --use_mesh in which only rank 0 writes files.

Each worker has 180 s; a timeout or a failed worker fails the test."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from madrona_bots_tpu.config import NUM_ACTIONS
from madrona_bots_tpu.config import EnvConfig as JaxConfig
from madrona_bots_tpu.env import env as jenv
from madrona_bots_tpu.env.state import init_state as jax_init_state
from madrona_bots_tpu.learn.a2c import init_train_states as jax_init_train_states
from madrona_bots_tpu.learn.ppo import make_ppo_trainer as jax_make_ppo_trainer
from madrona_bots_tpu.models import ActorCritic as JaxAC
from madrona_bots_tpu.models import SpeciesNetGenerator as JaxGen
from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.env import env as env_mod
from madrona_bots_tpu_torch.env.state import init_state, state_to_numpy
from madrona_bots_tpu_torch.learn import a2c, ppo
from madrona_bots_tpu_torch.learn import training_loop as cli
from test_multihost import _CHECKSUM
from test_torch_state import jax_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 180
W, A = 8, 16
A2C_CASES = {"slots_quirks": dict(learner_slots_per_class=3, quirk_compat=True),
             "stacked": dict(learner_slots_per_class=3, stacked=True)}
CLI = ["--num_worlds", "8", "--hidden_dim", "16", "--seed", "5", "--num_epochs", "2",
       "--create_universe", "--universe_id", "mh", "--device", "cpu"]

_COMMON = r"""
import numpy as np
import torch
from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.env.state import FIELDS, state_to_numpy
from madrona_bots_tpu_torch.learn import a2c
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator

cfg = EnvConfig(num_worlds=8, init_agents=8, max_agents=16)


def field_sums(a):
    # Each field's int32 values (f32 as their bits) summed exactly, world
    # keys left out: the parts of the JAX `_csum`. Of a shard, the per-world
    # fields' sums are its part of the global sums; `step_count` is
    # replicated, so the global sum counts one rank's.
    out = {}
    for f in FIELDS:
        if f != "world_keys":
            x = a[f].view(np.int32) if a[f].dtype == np.float32 else a[f].astype(np.int32)
            out[f] = int(x.astype(np.int64).sum())
    return out


def models_of(seed):
    gen = SpeciesNetGenerator(cfg.obs_dim, 6, 16, cfg.hidden_state_dim, seed=seed)
    return [ActorCritic.from_generator(gen) for _ in range(4)]


def train_leaves(ts):
    tss = [ts] if isinstance(ts, a2c.SpeciesTrainState) else list(ts)
    return [x for t in tss for x in (t.params, *t.opt_state)]


def a2c_run(make_tick, kw):
    models = models_of(4)
    tick, opt = make_tick(models, kw)
    init = a2c.init_stacked_train_state if kw.get("stacked") else a2c.init_train_states
    ts = init(models, rng.key(1), opt)
    return models, tick, ts
"""

_WORKER = r"""
import contextlib, io, json, sys
store, rank, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch_threads = 2
from madrona_bots_tpu_torch.parallel import distributed
mesh = distributed.initialize(f"file://{store}", 2, rank, device="cpu", timeout_s=150)
""" + _COMMON + r"""
torch.set_num_threads(torch_threads)
import torch.nn.functional as F
from madrona_bots_tpu_torch.env import env as env_mod
from madrona_bots_tpu_torch.env.state import init_state
from madrona_bots_tpu_torch.learn import ppo
from madrona_bots_tpu_torch.learn import training_loop as cli
from madrona_bots_tpu_torch.parallel import make_sharded_train_tick

lo, hi = mesh.world_range(cfg.num_worlds)
out = {"rank": rank, "worlds": [lo, hi]}

# (a) 10 env steps with per-step random actions, drawn globally, sliced.
s = init_state(cfg, 0, "cpu", worlds=(lo, hi))
for k in rng.split(rng.key(7), 10):
    a = rng.randint(k, (cfg.num_worlds, 16), 0, 6)[lo:hi].long()
    s = env_mod.step(env_mod.set_actions(s, F.one_hot(a, 6).to(torch.int32)), cfg,
                     use_kernels=False)
out["env_csum"] = field_sums(state_to_numpy(s))

# (b) two sharded A2C ticks per case.
out["a2c"] = {}
for name, kw in json.loads(sys.argv[4]).items():
    models, tick, ts = a2c_run(
        lambda m, k: make_sharded_train_tick(m, cfg, mesh, use_kernels=False, **k), kw)
    s = init_state(cfg, 0, "cpu", worlds=(lo, hi))
    for t in range(2):
        s, ts, m = tick(s, ts, rng.fold_in(rng.key(9), t))
    out["a2c"][name] = {
        "leaves": [x.tolist() for x in train_leaves(ts)],
        "metrics": {k: float(v) for k, v in m.items()},
        "alive": s.alive.tolist()}

# (c) one PPO iteration.
models = models_of(0)
it, opt = ppo.make_ppo_trainer(models, cfg, rollout_len=2, num_minibatches=2,
                               update_epochs=1, use_kernels=False, mesh=mesh)
ts = a2c.init_train_states(models, rng.key(1), opt)
ps, ts, metrics = it(init_state(cfg, 2, "cpu", worlds=(lo, hi)), ts, rng.key(3))
out["ppo_env_csum"] = field_sums(state_to_numpy(ps))
out["losses"] = {k: float(v) for k, v in metrics.items() if k.endswith("_loss")}
out["ppo_leaves"] = [x.tolist() for x in train_leaves(ts)]

# (d) the CLI with --use_mesh in this group, one save directory for both.
text = io.StringIO()
with contextlib.redirect_stdout(text):
    cli.main(json.loads(sys.argv[5]) + ["--model_save_dir", out_dir, "--use_mesh"])
out["cli_stdout"] = text.getvalue()
distributed.shutdown()
print(json.dumps(out), flush=True)
"""


NOT_BIT_EXACT_VS_JAX = {
    "env_csum": ("surrounding", "prev_surrounding"),
    "ppo_env_csum": ("surrounding", "prev_surrounding", "hidden", "prev_hidden")}


def csum(parts, skip=()) -> int:
    """The `_csum` of the fields but `skip` from one state's field sums, or
    from several shards' (step_count from the first): the int32 that their
    wrapping int32 sum gives."""
    total = sum(v for p in parts for f, v in p.items()
                if f not in skip and (f != "step_count" or p is parts[0])) % 2 ** 32
    return total - 2 ** 32 if total >= 2 ** 31 else total


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two workers' results, the single-process references)."""
    d = tmp_path_factory.mktemp("multihost")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    cli_flags = json.dumps(CLI + ["--algo", "a2c"])
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(d / "store"), str(r),
                               str(d / "cli"), json.dumps(A2C_CASES), cli_flags],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=str(d))
             for r in range(2)]
    try:
        ref = references(d)
        outs = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pytest.fail(f"a worker ran past {WORKER_TIMEOUT_S} s")
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs, ref, d


def references(d):
    """The JAX package's single-process env and PPO checksums and losses,
    the port's single-process A2C ticks and CLI run."""
    ns = {}
    exec(_CHECKSUM, ns)
    jcfg = JaxConfig(num_worlds=W, init_agents=8, max_agents=A)

    def full(s, k):
        a = jax.random.randint(k, (W, A), 0, NUM_ACTIONS)
        s = jenv.set_actions(s, jax.nn.one_hot(a, NUM_ACTIONS, dtype=jnp.int32))
        return jenv.sensor_pass(jenv.step_systems(s, jcfg), jcfg), ()

    cs = ns["_csum"]
    ns = {}
    exec(_COMMON, ns)
    s, _ = jax.jit(lambda s: jax.lax.scan(full, s, jax.random.split(jax.random.key(7), 10)))(
        jax_init_state(jax.random.key(0), jcfg))
    ref = {"jax_env_csum": ns["field_sums"](jax_arrays(s))}
    assert csum([ref["jax_env_csum"]]) == cs(s)            # the JAX rule, field by field
    gen = JaxGen(jcfg.obs_dim, 6, 16, jcfg.hidden_state_dim, seed=0)
    jmodels = [JaxAC.from_generator(gen) for _ in range(4)]
    it, opt = jax_make_ppo_trainer(jmodels, jcfg, rollout_len=2, num_minibatches=2,
                                   update_epochs=1)
    ps, _, metrics = it(jax_init_state(jax.random.key(2), jcfg),
                        jax_init_train_states(jmodels, jax.random.key(1), opt),
                        jax.random.key(3))
    ref["jax_ppo_env_csum"] = ns["field_sums"](jax_arrays(ps))
    ref["losses"] = {k: float(v) for k, v in metrics.items() if k.endswith("_loss")}

    cfg = ns["cfg"]
    s = init_state(cfg, 0, "cpu")
    for k in rng.split(rng.key(7), 10):
        a = rng.randint(k, (W, A), 0, NUM_ACTIONS).long()
        s = env_mod.step(env_mod.set_actions(s, F.one_hot(a, NUM_ACTIONS).to(torch.int32)), cfg,
                         use_kernels=False)
    ref["env_csum"] = ns["field_sums"](state_to_numpy(s))
    models = ns["models_of"](0)
    it, opt = ppo.make_ppo_trainer(models, cfg, rollout_len=2, num_minibatches=2,
                                   update_epochs=1, use_kernels=False)
    ps, _, _ = it(init_state(cfg, 2, "cpu"), a2c.init_train_states(models, rng.key(1), opt),
                  rng.key(3))
    ref["ppo_env_csum"] = ns["field_sums"](state_to_numpy(ps))
    ref["a2c"] = {}
    for name, kw in A2C_CASES.items():
        _, tick, ts = ns["a2c_run"](
            lambda m, k: a2c.make_train_tick(m, ns["cfg"], use_kernels=False, **k), kw)
        s = init_state(ns["cfg"], 0, "cpu")
        for t in range(2):
            s, ts, m = tick(s, ts, rng.fold_in(rng.key(9), t))
        ref["a2c"][name] = {"leaves": [x.numpy() for x in ns["train_leaves"](ts)],
                            "metrics": {k: float(v) for k, v in m.items()},
                            "alive": s.alive.numpy()}
    cli.main(CLI + ["--algo", "a2c", "--model_save_dir", str(d / "cli_one")])
    return ref


@pytest.mark.parametrize("name", ["env_csum", "ppo_env_csum"])
def test_env_checksums_equal_one_process_and_jax(runs, name):
    outs, ref, _ = runs
    assert [o["worlds"] for o in outs] == [[0, 4], [4, 8]]
    parts = [o[name] for o in outs]
    assert csum(parts) == csum([ref[name]])
    skip = NOT_BIT_EXACT_VS_JAX[name]
    assert csum(parts, skip) == csum([ref["jax_" + name]], skip)


def test_ppo_losses_equal_jax(runs):
    outs, ref, _ = runs
    for o in outs:
        for k, v in ref["losses"].items():
            assert abs(o["losses"][k] - v) < 1e-4 * max(1.0, abs(v)), (k, o["losses"][k], v)
    assert outs[0]["ppo_leaves"] == outs[1]["ppo_leaves"]      # replicated, in bits


@pytest.mark.parametrize("name", list(A2C_CASES))
def test_a2c_ticks_match_one_process(runs, name):
    outs, ref, _ = runs
    want = ref["a2c"][name]
    assert outs[0]["a2c"][name]["leaves"] == outs[1]["a2c"][name]["leaves"]
    for a, b in zip(want["leaves"], outs[0]["a2c"][name]["leaves"]):
        np.testing.assert_allclose(np.asarray(b, a.dtype), a, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(np.concatenate([o["a2c"][name]["alive"] for o in outs]),
                                  want["alive"])
    for o in outs:
        for sp in range(1, 5):
            for k in ("dropped_rows", "count"):
                key = f"species_{sp}_{k}"
                assert o["a2c"][name]["metrics"][key] == want["metrics"][key], key


def test_cli_writes_only_on_rank_0(runs):
    outs, _, d = runs
    assert "Saved model" in outs[0]["cli_stdout"]
    assert "Saved model" not in outs[1]["cli_stdout"]
    assert all("mesh: 2 devices, worlds sharded" in o["cli_stdout"] for o in outs)
    with open(d / "cli" / "universe_mh-r8.metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [1, 2]
    for sp in range(1, 5):
        names = os.listdir(d / "cli" / "universe_mh" / f"species_{sp}")
        assert "latest_model_epoch_2.ckpt.npz" in names
        with np.load(d / "cli" / "universe_mh" / f"species_{sp}" / "latest_model_epoch_2.ckpt.npz") as a, \
                np.load(d / "cli_one" / "universe_mh" / f"species_{sp}" /
                        "latest_model_epoch_2.ckpt.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-3, atol=1e-4, err_msg=k)
