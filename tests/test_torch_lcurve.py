"""The learning-curve drivers (`tools/lcurve.py`) on the CPU at small size.

* Against the JAX package: the loop of `artifacts/lcurve_seeds.py` (A2C,
  both objectives) and of `artifacts/ppo_multiseed_r5.py` (PPO), rebuilt
  here from the JAX package's functions (the scripts read `sys.argv` at
  import): a jitted `lax.scan` block over `split(fold_in(key(seed), b),
  block)`, `use_pallas=True` with the Pallas kernels in interpret mode, as
  the JAX package's kernel tests run them on the CPU. 8 worlds, hidden 32,
  f32, 2 blocks. The series' counts and the final world state's integer
  fields are equal; floats are held to the f32 tolerances of
  tests/test_torch_a2c.py and tests/test_torch_ppo.py.
* Resumed equals straight in bits: 4 blocks in one call against 2 + 2
  through the resume directory, A2C and PPO, at the production dtype
  (bf16, learner slots).
* `bands` on the JAX records alone reproduces their cross-seed bands and
  `ppo_multiseed_r5.jsonl`'s own summary line; the rule's in, miss and
  zero-sd cases.
"""

import json
from functools import partial

import jax
import numpy as np
import pytest
import torch

from madrona_bots_tpu import EnvConfig as JaxConfig
from madrona_bots_tpu.env.state import init_state as jax_init_state
from madrona_bots_tpu.learn import a2c as ja2c
from madrona_bots_tpu.learn import ppo as jppo
from madrona_bots_tpu.models import ActorCritic as JaxAC
from madrona_bots_tpu.models import SpeciesNetGenerator as JaxGen
from madrona_bots_tpu.ops import raycast_pallas, step_pallas
from madrona_bots_tpu_torch.env.state import FIELDS, state_to_numpy
from madrona_bots_tpu_torch.tools import lcurve
from test_torch_a2c import jax_train_states_to_port
from test_torch_state import jax_arrays

W, HIDDEN, SEED, LR = 8, 32, 3, 3e-4
A2C_BLOCK, PPO_BLOCK, PPO_T, BLOCKS = 4, 2, 4, 2


def jax_loop(step, keep, state, tstates, seed, block, blocks):
    """The JAX scripts' driver loop: block b is one jitted `lax.scan` over
    `split(fold_in(key(seed), b), block)`; its metrics leave the device once."""
    @partial(jax.jit, donate_argnums=(0, 1))
    def run_block(state, tstates, key):
        def body(carry, k):
            s, ts = carry
            s, ts, m = step(s, ts, k)
            return (s, ts), keep(m)
        (state, tstates), ms = jax.lax.scan(body, (state, tstates), jax.random.split(key, block))
        return state, tstates, ms

    series = {}
    for b in range(blocks):
        state, tstates, ms = run_block(state, tstates,
                                       jax.random.fold_in(jax.random.key(seed), b))
        for k, v in jax.device_get(ms).items():
            series.setdefault(k, []).append(np.asarray(v))
    return state, tstates, {k: np.concatenate(v) for k, v in series.items()}


def jax_run(spec):
    """(JAX final state as numpy, train states as port tensors, series) of
    the JAX driver loop for `spec`, with the Pallas kernels interpreted."""
    cfg = JaxConfig(num_worlds=spec.worlds, init_agents=32, max_agents=128)
    gen = JaxGen(cfg.obs_dim, 6, spec.hidden, cfg.hidden_state_dim, seed=spec.seed)
    models = [JaxAC.from_generator(gen) for _ in range(4)]
    if spec.algo == "ppo":
        step, opt = jppo.make_ppo_trainer(models, cfg, rollout_len=spec.rollout,
                                          use_pallas=True, learner_slots_per_class=spec.slots)

        def keep(m):
            out = {f"species_{i}_{n}": m[f"species_{i}_{n}"]
                   for i in range(1, 5) for n in lcurve.PPO_KEEP}
            out["dropped"] = sum(m[f"species_{i}_dropped_rows"] for i in range(1, 5))
            return out
    else:
        step, opt = ja2c.make_train_tick(models, cfg, proper_log_probs=spec.objective == "proper",
                                         quirk_compat=True, use_pallas=True,
                                         learner_slots_per_class=spec.slots)

        def keep(m):
            return {f"species_{i}_{n}": m[f"species_{i}_{n}"]
                    for i in range(1, 5) for n in lcurve.A2C_KEEP}
    tstates = ja2c.init_train_states(models, jax.random.key(spec.seed), opt)
    state = jax_init_state(jax.random.key(spec.seed + 1000), cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(step_pallas, "fused_step_systems",
                   partial(step_pallas.fused_step_systems, interpret=True))
        mp.setattr(raycast_pallas, "raycast_pallas",
                   partial(raycast_pallas.raycast_pallas, interpret=True))
        state, tstates, series = jax_loop(step, keep, state, tstates, spec.seed, spec.block,
                                          spec.steps // spec.block)
    port_models = lcurve.Driver(spec, "cpu").start().models
    return jax_arrays(state), jax_train_states_to_port(port_models, tstates), series


SPECS = {
    "a2c_raw_logit": lcurve.a2c_spec("raw_logit", SEED, epochs=A2C_BLOCK * BLOCKS, worlds=W,
                                     block=A2C_BLOCK, hidden=HIDDEN, dtype="f32"),
    "a2c_proper": lcurve.a2c_spec("proper", SEED, epochs=A2C_BLOCK * BLOCKS, worlds=W,
                                  block=A2C_BLOCK, hidden=HIDDEN, dtype="f32"),
    "ppo": lcurve.ppo_spec(SEED, iters=PPO_BLOCK * BLOCKS, worlds=W, block=PPO_BLOCK,
                           hidden=HIDDEN, dtype="f32", rollout=PPO_T),
}
# Series that count or sum integers: equal in both packages.
EXACT = ("count_per_world", "avg_health", "count", "dropped")


@pytest.fixture(scope="module")
def against_jax():
    return {}


def get(cache, name):
    if name not in cache:
        spec = SPECS[name]
        drv = lcurve.Driver(spec, "cpu").start()
        drv.advance()
        cache[name] = (jax_run(spec), drv)
    return cache[name]


@pytest.mark.parametrize("name", list(SPECS))
def test_driver_matches_jax_loop(against_jax, name):
    (jstate, jts, jseries), drv = get(against_jax, name)
    pseries = drv.series_dict()
    assert sorted(pseries) == sorted(jseries)
    steps = drv.spec.steps
    for k, want in jseries.items():
        got = pseries[k]
        assert got.shape == want.shape == (steps,), k
        if k.endswith(EXACT):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            # test_torch_a2c.py / test_torch_ppo.py's f32 metric tolerance.
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=k)
    got_state = state_to_numpy(drv.state)
    for f in FIELDS:
        if f in ("surrounding", "prev_surrounding"):       # SPEC D10
            np.testing.assert_allclose(got_state[f], jstate[f], rtol=1e-5, atol=1e-4, err_msg=f)
        elif f in ("hidden", "prev_hidden"):
            # The memory follows the parameters (held below); the rows
            # written back are the same.
            assert np.array_equal((got_state[f] != 0).any(-1), (jstate[f] != 0).any(-1)), f
        elif f in ("reward", "prev_reward"):
            # The jitted fused Pallas path rounds the reward sums a few ulps
            # apart from the jitted spec path, which the port follows
            # (ROADMAP.md §3).
            np.testing.assert_allclose(got_state[f], jstate[f], rtol=1e-6, atol=1e-7, err_msg=f)
        else:
            assert int((got_state[f] != jstate[f]).sum()) == 0, f
    # Parameters: test_torch_a2c.py's bounds of one tick, within 2 lr
    # everywhere and a mean difference under lr / 20, an Adam step each (a
    # gradient behind XLA:CPU's saturating tanh is 0 in JAX and ~1e-9 in
    # torch, and Adam's step turns that into up to lr; over several steps
    # the other gradients follow).
    adam_steps = steps * (8 if drv.spec.algo == "ppo" else 1)
    for j, t in zip(jts, drv.train_states):
        assert int(t.opt_state.count) == int(j.opt_state.count) == adam_steps
        diff = (t.params - j.params).abs()
        assert float(diff.max()) <= 2 * LR * adam_steps, name
        assert float(diff.mean()) < LR / 20 * adam_steps, name


def bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x).view(np.uint8)


def assert_drivers_equal(a, b):
    assert a.next_block == b.next_block
    assert np.array_equal(bits(a.series), bits(b.series))
    for x, y in zip(a.train_states, b.train_states):
        for u, v in ((x.params, y.params), (x.opt_state.mu, y.opt_state.mu),
                     (x.opt_state.nu, y.opt_state.nu), (x.opt_state.count, y.opt_state.count)):
            assert torch.equal(u.view(torch.int32) if u.dtype == torch.float32 else u,
                               v.view(torch.int32) if v.dtype == torch.float32 else v)
    sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
    for f in FIELDS:
        assert np.array_equal(bits(sa[f]), bits(sb[f])), f


RESUME = {
    "a2c": lcurve.a2c_spec("proper", 1, epochs=8, worlds=W, block=2, hidden=HIDDEN),
    "ppo": lcurve.ppo_spec(2, iters=4, worlds=W, block=1, hidden=HIDDEN, rollout=PPO_T),
}
ROW_CLOCK = ("fps", "env_steps_per_s", "device", "shared_card", "calls")


@pytest.mark.parametrize("algo", list(RESUME))
def test_resumed_equals_straight_in_bits(tmp_path, algo):
    spec = RESUME[algo]
    straight = lcurve.Driver(spec, "cpu").start()
    assert straight.advance()
    first = lcurve.Driver(spec, "cpu", str(tmp_path)).start()
    assert not first.advance(max_blocks=2)
    assert first.newest_point().endswith("b000002")
    resumed = lcurve.Driver(spec, "cpu", str(tmp_path)).start()
    assert resumed.next_block == 2 and resumed.calls == 2
    assert resumed.advance()
    assert_drivers_equal(straight, resumed)
    a, b = straight.row("cpu", 1), resumed.row("cpu", 1)
    assert {k: v for k, v in a.items() if k not in ROW_CLOCK} == \
        {k: v for k, v in b.items() if k not in ROW_CLOCK}


def test_budget_stops_then_resumes_and_appends_once(tmp_path):
    """The command line: a budget of 0 s runs one block and exits 75 with a
    resume point; the same command finishes the run and appends its row; a
    third call appends nothing."""
    out = tmp_path / "rows.jsonl"
    argv = ["a2c", "--objective", "raw_logit", "--seeds", "4", "--worlds", "4", "--epochs",
            "4", "--block", "2", "--hidden", str(HIDDEN), "--device", "cpu", "--out",
            str(out), "--resume-dir", str(tmp_path / "points")]
    assert lcurve.main(argv + ["--max-seconds", "0"]) == lcurve.STOPPED
    assert not out.exists()
    run = lcurve.a2c_spec("raw_logit", 4, epochs=4, worlds=4, block=2, hidden=HIDDEN).name
    assert (tmp_path / "points" / run / "b000001" / "state.npz").exists()
    assert lcurve.main(argv) == 0
    assert lcurve.main(argv) == 0
    rows = lcurve.read_rows(str(out))
    assert len(rows) == 1 and rows[0]["run"] == run and rows[0]["calls"] == 2
    assert rows[0]["epochs"] == 4 and len(rows[0]["series"]["species_1_reward"]) == 1
    assert not (tmp_path / "points" / run).exists()


def test_driver_defaults_to_cuda():
    spec = RESUME["a2c"]
    if torch.cuda.is_available():
        assert lcurve.Driver(spec).dev.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            lcurve.Driver(spec)


# The cross-seed bands of the JAX records, recomputed from them: (mean, sd,
# min, max) of each seed's statistic.
JAX_BANDS = {
    ("raw_logit", "avg_action_entropy"): (0.4249, 0.2141, 0.1126, 0.6516),
    ("raw_logit", "count_per_world"): (8.0080, 0.0029, 8.0055, 8.0134),
    ("raw_logit", "reward"): (-683.3961, 849.1494, -1709.8930, 306.7345),
    ("raw_logit", "avg_health"): (94.0110, 0.3799, 93.4648, 94.6062),
    ("proper", "avg_action_entropy"): (0.0265, 0.0021, 0.0242, 0.0296),
    ("proper", "count_per_world"): (8.0000, 0.0000, 8.0000, 8.0000),
    ("proper", "reward"): (-4893.8178, 28.6147, -4934.9832, -4855.2583),
    ("proper", "avg_health"): (97.1288, 0.0697, 97.0585, 97.2423),
}


def test_bands_reproduce_jax_records():
    comps = lcurve.compare(lcurve.read_rows(lcurve.JAX_A2C), lcurve.read_rows(lcurve.JAX_PPO),
                           [], [])
    assert len(comps) == 12
    for c in comps:
        assert c["port"] is None and c["in"] is None
    by = {(c["objective"], c["metric"]): c for c in comps}
    for key, want in JAX_BANDS.items():
        j = by[key]["jax"]
        assert j["n"] == 5
        assert [round(j[k], 4) for k in ("mean", "sd", "min", "max")] == list(want), key
    summary = [r for r in lcurve.read_rows(lcurve.JAX_PPO) if r.get("kind") == "summary"][0]
    for metric in lcurve.PPO_KEEP:
        c = by[("ppo_slots8", metric)]
        assert c["jax"]["n"] == 3
        want = summary[metric]
        assert round(c["jax"]["mean"], 4) == want["mean"], metric
        assert round(c["jax"]["sd"], 4) == want["sd"], metric
        assert [round(c["jax"]["min"], 4), round(c["jax"]["max"], 4)] == want["range"], metric
        assert round(c["control_slots12"]["jax"], 4) == want["control_slots12"], metric


def test_rule_in_miss_and_zero_sd_floor():
    def band(values):
        return lcurve.stats(values)

    jax_band = band([0.40, 0.45, 0.50])               # mean 0.45, sd 0.0408
    inside = lcurve.rule(jax_band, band([0.47, 0.50, 0.53]))
    assert inside["in"] and inside["seeds_in_range"] == 2
    port = band([0.60, 0.62, 0.64])
    miss = lcurve.rule(jax_band, port)
    assert not miss["in"] and miss["seeds_in_range"] == 0
    assert miss["tol"] == pytest.approx(2 * np.sqrt(jax_band["sd"] ** 2 / 3 + port["sd"] ** 2 / 3))
    # Proper count: 8.0 +- 0 in both: the floor 1e-3 * |mean| decides.
    flat = band([8.0] * 5)
    assert lcurve.rule(flat, band([8.0] * 5))["in"]
    assert lcurve.rule(flat, band([8.007] * 5))["in"]
    assert not lcurve.rule(flat, band([8.009] * 5))["in"]


def test_bands_command_reads_port_rows(tmp_path, capsys):
    """A port file with the JAX rows' configuration is compared; rows of
    another size are not. `--window` lists where the curves part."""
    rows = [r for r in lcurve.read_rows(lcurve.JAX_A2C)]
    port = tmp_path / "a2c.jsonl"
    with open(port, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write(json.dumps(dict(rows[0], worlds=8, seed=10)) + "\n")
    assert lcurve.main(["bands", "--port-a2c", str(port), "--port-ppo",
                        str(tmp_path / "none.jsonl"), "--window", "160", "--json"]) == 0
    comps = json.loads(capsys.readouterr().out)
    for c in comps[:8]:
        assert c["port"]["n"] == 5 and c["in"] and c["diff"] == 0.0
        assert c["seeds_in_range"] == 5 and c["outside"] == []
    for c in comps[8:]:
        assert c["port"] is None and "outside" not in c


def test_parting_finds_the_windows_outside_the_jax_range():
    jax_w = np.array([[1.0, 2.0, 3.0, 4.0], [1.5, 2.5, 3.5, 4.5]])
    assert lcurve.parting(jax_w, np.array([[1.2, 2.2, 3.2, 4.2]])) == []
    assert lcurve.parting(jax_w, np.array([[1.2, 2.2, 5.0, 4.2], [1.2, 2.2, 5.0, 4.0]])) == [2]
    assert lcurve.parting(jax_w, np.array([[0.0, 2.2, 3.2, 9.0]])) == [0, 3]
    row = {"series_every": 10, "series": {f"species_{i}_reward": [float(i), 0.0, 2.0, 4.0]
                                          for i in range(1, 5)}}
    np.testing.assert_allclose(lcurve.window_means([row], "reward", 20), [[1.25, 3.0]])
