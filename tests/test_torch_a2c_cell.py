"""The benchmark's A2C cell (`upstream-a2c-w2048.train` in `portbench/`) on
the CPU at 4 worlds x 128 slots and the published widths: the port's tick
against the plain reference `portbench/reference/a2c.py` (one tick, three
chained), held to the cell's limits; the configuration's nets against the
CLI's default draw; the cell's driver correct, and not correct under two
faults; the CLI's loop body (`training_loop.run_tick`) against
`a2c.rollout_train` and against the driver's seeding."""

import json
import os

import pytest
import torch

from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.config import EnvConfig, RewardSetting
from madrona_bots_tpu_torch.env.state import FIELDS, init_state
from madrona_bots_tpu_torch.learn import a2c, training_loop
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator
from portbench import compare, core, run
from portbench.reference import a2c as ref
from portbench.reference import config as ref_config
from portbench.reference import rng as ref_rng

CELL = "upstream-a2c-w2048.train"
CONFIG = core.data("configs", "upstream-a2c-w2048")
LIMITS = core.data("workloads", CELL)["check"]["limits"]
SMALL = {"num_worlds": 4}
SEED = 2**31 + 19


def port_run(seed, num_worlds=4):
    """The cell's program at `num_worlds`, seeded as the CLI seeds it: (cfg,
    models, tick on the plain path, state, train states, loop key)."""
    cfg = EnvConfig(num_worlds=num_worlds, init_agents=32, max_agents=CONFIG["max_agents"],
                    num_species=CONFIG["num_species"],
                    reward_setting=RewardSetting(CONFIG["reward_setting"]))
    models = [ActorCritic(arch) for arch in CONFIG["species_nets"]]
    tick, opt = a2c.make_train_tick(models, cfg, lr=CONFIG["lr"], gamma=CONFIG["gamma"],
                                    use_kernels=False)
    init_key = rng.key(seed)
    ts = tuple(a2c.SpeciesTrainState(p, opt.init(p)) for p in
               (m.flatten(m.init(rng.fold_in(init_key, sp))) for sp, m in enumerate(models, 1)))
    return cfg, models, tick, init_state(cfg, seed, "cpu"), ts, rng.key(seed + 1)


@pytest.mark.parametrize("ticks", [1, 3])
def test_port_tick_against_the_reference(ticks):
    """Program and reference each run their own chain from the same start;
    every tick's numbers (`tick_numbers`) stay within the cell's limits."""
    driver = core.plugin("drivers", "a2c")
    cfg, models, tick, state, ts, key = port_run(SEED)
    rcfg = ref_config.EnvConfig(num_worlds=cfg.num_worlds, init_agents=32,
                                max_agents=cfg.max_agents, num_species=cfg.num_species,
                                reward_setting=ref_config.RewardSetting(8))
    rstate = state.replace(**{f: getattr(state, f).clone() for f in FIELDS})
    rts, rkey = [(t.params, tuple(t.opt_state)) for t in ts], key
    alive = []
    for _ in range(ticks):
        ts0 = ts
        state, ts, key, metrics = training_loop.run_tick(tick, state, ts, key)
        rstate, records = ref.tick(rstate, rts, rkey, rcfg, CONFIG["species_nets"],
                                   CONFIG["lr"], CONFIG["gamma"])
        rkey = ref_rng.split(rkey, 2)[0]
        rts = [(r["params"], r["opt"]) for r in records]

        def logits_of(s, obs, mem):
            return a2c.policy_forward(models[s], ts0[s].params, obs, mem)[0]

        n = driver.tick_numbers(state, ts0, ts, metrics, rstate, records, logits_of,
                                cfg.num_species, LIMITS["logit_gap"])
        failed, checks = compare.judge(n, LIMITS)
        assert failed == 0, json.dumps(checks)
        assert torch.equal(key, rkey)
        alive.append([int(r["mask"].sum()) for r in records])
    assert all(min(a) > 0 for a in alive), alive      # every species trained every tick


def test_configuration_nets_are_the_cli_default_draw():
    gen = SpeciesNetGenerator(CONFIG["obs_dim"], CONFIG["action_dim"], CONFIG["hidden_dim"],
                              CONFIG["memory_dim"], seed=CONFIG["net_generator_seed"])
    assert CONFIG["net_generator_seed"] == training_loop.build_parser().get_default("seed")
    assert CONFIG["species_nets"] == [gen.sample_config() for _ in CONFIG["species_nets"]]
    kinds = [n["recurrent"]["type"] for n in CONFIG["species_nets"]]
    assert kinds == ["GRU", "GRU", "RNN", "LSTM"]


def _skip_adam(monkeypatch):
    monkeypatch.setattr(a2c.Adam, "update", lambda self, grad, state, params: (params, state))


def _one_memory_unwritten(monkeypatch):
    """Species 2's new memory is the memory it read: the tick writes it back
    unchanged."""
    species_grad = a2c._species_grad
    calls = []

    def grad(model, ts, obs_cur, obs_prev, mem_cur, *rest):
        out = species_grad(model, ts, obs_cur, obs_prev, mem_cur, *rest)
        calls.append(None)
        if len(calls) % 4 == 2:
            out = (out[0], out[1], mem_cur.clone(), out[3])
        return out
    monkeypatch.setattr(a2c, "_species_grad", grad)


@pytest.mark.parametrize("fault", [None, _skip_adam, _one_memory_unwritten],
                         ids=["program", "adam_step_skipped", "one_memory_unwritten"])
def test_driver_run_is_correct_and_faults_are_not(fault, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    r = run.measure(CELL, SEED, 0.3, False, device="cpu", config_overrides=SMALL)
    assert r["attempted"] >= 1 and r["checks"]["state_mismatch"]["value"] == 0
    if fault is None:
        assert r["correct"], r["checks"]
    else:
        assert not r["correct"] and r["failed"] >= 1, r["checks"]


def test_run_tick_is_the_scan_and_the_cli_loop(tmp_path):
    """`_train` at --ticks_per_block 1 (through `run_tick`) gives the
    metrics and final parameters of `a2c.rollout_train` from the CLI's
    seeding, and the cell's driver seeds and steps as the CLI does."""
    save = str(tmp_path)
    args = training_loop.build_parser().parse_args(
        ["--num_worlds", "2", "--num_epochs", "3", "--create_universe", "--universe_id", "t",
         "--model_save_dir", save, "--device", "cpu", "--seed", "0"])
    state, ts = training_loop.train(args)
    with open(os.path.join(save, "universe_t-r8.metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]

    cfg, models, tick, s0, ts0, key = port_run(0, num_worlds=2)
    s3, ts3, ms = a2c.rollout_train(tick, s0, ts0, key, 3)
    for f in FIELDS:
        assert torch.equal(getattr(state, f), getattr(s3, f)), f
    for a, b in zip(ts, ts3):
        assert torch.equal(a.params, b.params) and torch.equal(a.opt_state.mu, b.opt_state.mu)
    for i, row in enumerate(rows):
        for name, v in ms.items():
            assert row[name] == float(v[i]), name

    drv = core.plugin("drivers", "a2c").Driver(
        {**CONFIG, "num_worlds": 2}, {**core.data("workloads", CELL), "warmup": 3}, 0,
        torch.device("cpu"), False)
    assert all(torch.equal(a.params, b.params) for a, b in zip(drv.train_states, ts))
    for f in FIELDS:
        assert torch.equal(getattr(drv.state, f), getattr(state, f)), f
    drv.finish()
