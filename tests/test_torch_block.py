"""The port's training CLI in its stacked (--stacked) and block
(--ticks_per_block K > 1) modes, on the CPU.

Stacked runs create and restore universes (A2C and PPO); a universe from a
stacked run of either package loads in the other package's loop and
stacked modes with its parameters and Adam state bit for bit. The block
keeps the JAX package's semantics: a block equals K ticks under the JAX key
schedule (one split a tick), exactly; the best-checkpoint invariant of
tests/test_block_best.py (each best_* file's epoch is the argmin epoch of
its logged metric; a mid-block best differs from the block-end
parameters); and the logged rows hold the JAX block-mode CLI's keys.
"""

import glob
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from madrona_bots_tpu.learn import training_loop as jax_cli
from madrona_bots_tpu_torch import init_state, rng
from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.env.state import FIELDS
from madrona_bots_tpu_torch.learn import a2c, ppo
from madrona_bots_tpu_torch.learn import training_loop as cli
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator
from madrona_bots_tpu_torch.models.stacked import StackedActorCritic

BASE = ["--num_worlds", "8", "--hidden_dim", "32", "--seed", "5"]
PPO = ["--algo", "ppo", "--rollout_len", "2"]
NS = 4


def metric_rows(save_dir, uid):
    with open(os.path.join(save_dir, f"universe_{uid}-r8.metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def latest_file(root, uid, sp):
    files = glob.glob(os.path.join(root, f"universe_{uid}", f"species_{sp}",
                                   "latest_model_epoch_*.ckpt.npz"))
    assert len(files) == 1, files
    return files[0]


def file_leaves(path):
    """(config, parameter leaves, Adam leaves) of a checkpoint file."""
    with np.load(path) as z:
        config = json.loads(bytes(z["model_config"]).decode())
        p = [np.array(z[k]) for k in sorted((k for k in z.files if k.startswith("p_")),
                                            key=lambda k: int(k[2:]))]
        o = [np.array(z[f"o_{i}"]) for i in range(3)]
    return config, p, o


def universe(root, uid):
    """Per species (config, parameter leaves, Adam leaves) of its latest files."""
    return [file_leaves(latest_file(root, uid, sp)) for sp in range(1, NS + 1)]


@pytest.fixture(scope="module")
def stacked_runs(tmp_path_factory):
    """The port's --stacked CLI, A2C and PPO: create a universe with 3
    epochs, then restore it for 2 more."""
    d = str(tmp_path_factory.mktemp("stacked"))
    for uid, extra in (("a", []), ("p", PPO)):
        cli.main(BASE + extra + ["--stacked", "--device", "cpu", "--model_save_dir", d,
                                 "--universe_id", uid, "--num_epochs", "3",
                                 "--create_universe"])
        cli.main(BASE + extra + ["--stacked", "--device", "cpu", "--model_save_dir", d,
                                 "--universe_id", uid, "--num_epochs", "2"])
    return d


@pytest.mark.parametrize("uid", ["a", "p"])
def test_stacked_create_then_restore(stacked_runs, uid):
    d = stacked_runs
    for sp in range(1, NS + 1):
        names = sorted(os.listdir(os.path.join(d, f"universe_{uid}", f"species_{sp}")))
        assert "latest_model_epoch_5.ckpt.npz" in names
        with np.load(latest_file(d, uid, sp)) as z:
            assert int(z["o_0"]) == (5 if uid == "a" else 5 * 8)
        # PPO logs no A2C loss, so it keeps no best file.
        assert any(n.startswith("best_total_loss_epoch_") for n in names) == (uid == "a")
    rows = metric_rows(d, uid)
    assert [r["epoch"] for r in rows] == [1, 2, 3, 4, 5]
    for r in rows:
        assert all(np.isfinite(v) for v in r.values() if isinstance(v, float))


@pytest.mark.parametrize("stacked", [False, True])
def test_port_stacked_universe_loads_in_jax_cli(stacked_runs, stacked):
    """The JAX CLI restores the port's stacked A2C universe in its loop and
    its stacked mode with the files' parameters and Adam state."""
    u = universe(stacked_runs, "a")
    args = cli.build_parser().parse_args(
        BASE + ["--model_save_dir", stacked_runs, "--universe_id", "a", "--num_epochs", "0"]
        + (["--stacked"] if stacked else []))
    _, tstates = jax_cli.train(args)
    if stacked:
        sac = StackedActorCritic([ActorCritic(c) for c, _, _ in u])
        want_p = sac.stack_params([torch.from_numpy(np.concatenate([x.ravel() for x in p]))
                                   for _, p, _ in u])
        want_o = sac.stack_opt_state([a2c.AdamState(*(torch.from_numpy(x) for x in o))
                                      for _, _, o in u])
        got_p = torch.cat([torch.from_numpy(np.array(x)).ravel()
                           for x in jax.tree.leaves(tstates.params)])
        assert torch.equal(got_p, want_p)
        for a, b in zip(jax.tree.leaves(tstates.opt_state), want_o):
            assert torch.equal(torch.from_numpy(np.array(a)), b)
    else:
        for ts, (_, p, o) in zip(tstates, u):
            for a, b in zip(jax.tree.leaves(ts.params), p):
                np.testing.assert_array_equal(np.asarray(a), b)
            for a, b in zip(jax.tree.leaves(ts.opt_state), o):
                np.testing.assert_array_equal(np.asarray(a), b)


@pytest.fixture(scope="module")
def jax_stacked_universe(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_stacked"))
    jax_cli.main(BASE + ["--stacked", "--model_save_dir", d, "--universe_id", "j",
                         "--num_epochs", "2", "--create_universe"])
    return d


@pytest.mark.parametrize("stacked", [False, True])
def test_jax_stacked_universe_loads_in_port(jax_stacked_universe, tmp_path, stacked):
    """The port restores the JAX CLI's stacked A2C universe in its loop and
    stacked modes, with the files' parameters and Adam state, and trains
    on from there."""
    src = jax_stacked_universe
    u = universe(src, "j")
    extra = ["--stacked"] if stacked else []
    args = cli.build_parser().parse_args(
        BASE + extra + ["--device", "cpu", "--model_save_dir", src, "--universe_id", "j",
                        "--num_epochs", "0"])
    _, tstates = cli.train(args)
    if stacked:
        sac = StackedActorCritic([ActorCritic(c) for c, _, _ in u])
        tstates = [a2c.SpeciesTrainState(p, o) for p, o in zip(
            sac.unstack_params(tstates.params), sac.unstack_opt_state(tstates.opt_state))]
    for ts, (c, p, o) in zip(tstates, u):
        assert torch.equal(ts.params, ActorCritic(c).flatten([torch.from_numpy(x) for x in p]))
        for a, b in zip(ts.opt_state, o):
            assert torch.equal(a, torch.from_numpy(b))
    t = str(tmp_path)
    shutil.copytree(os.path.join(src, "universe_j"), os.path.join(t, "universe_j"))
    cli.main(BASE + extra + ["--device", "cpu", "--model_save_dir", t, "--universe_id", "j",
                             "--num_epochs", "1"])
    for sp in range(1, NS + 1):
        with np.load(latest_file(t, "j", sp)) as z:
            assert latest_file(t, "j", sp).endswith("latest_model_epoch_3.ckpt.npz")
            assert int(z["o_0"]) == 3


@pytest.mark.parametrize("stacked", [False, True])
def test_block_best_matches_logged_argmin(tmp_path, stacked):
    """tests/test_block_best.py's invariant on the port's block mode: seed 3,
    K = 4, 8 epochs."""
    save_dir = str(tmp_path / "ckpts")
    cli.main(["--num_worlds", "8", "--num_epochs", "8", "--ticks_per_block", "4",
              "--create_universe", "--universe_id", "bb", "--model_save_dir", save_dir,
              "--hidden_dim", "32", "--seed", "3", "--ckpt_every", "100", "--device", "cpu"]
             + (["--stacked"] if stacked else []))
    series = [r for r in metric_rows(save_dir, "bb") if "species_1_total_loss" in r]
    assert len(series) == 8
    mid_block_hits = 0
    for sp in range(1, NS + 1):
        for metric in cli.BEST_METRICS:
            vals = [r[f"species_{sp}_{metric}"] for r in series]
            argmin_epoch = int(np.argmin(vals)) + 1
            files = glob.glob(os.path.join(save_dir, "universe_bb", f"species_{sp}",
                                           f"best_{metric}_epoch_*.ckpt.npz"))
            assert len(files) == 1, (sp, metric, files)
            file_epoch = int(files[0].split("_")[-1].split(".")[0])
            assert file_epoch == argmin_epoch, (sp, metric, file_epoch, argmin_epoch)
            if file_epoch not in (4, 8):
                mid_block_hits += 1
                with np.load(files[0]) as a, np.load(latest_file(save_dir, "bb", sp)) as b:
                    assert any(not np.array_equal(a[k], b[k])
                               for k in a.files if k.startswith("p_")), (sp, metric)
    assert mid_block_hits >= 1, "no mid-block best epochs; pick another seed"


@pytest.mark.parametrize("algo", [[], PPO])
def test_block_metric_keys_match_jax_cli(tmp_path, algo):
    flags = BASE + algo + ["--ticks_per_block", "2", "--num_epochs", "2",
                           "--create_universe", "--universe_id", "k"]
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_cli.main(flags + ["--model_save_dir", j])
    cli.main(flags + ["--model_save_dir", t, "--device", "cpu"])
    jrows, trows = metric_rows(j, "k"), metric_rows(t, "k")
    assert len(jrows) == len(trows) == 2
    for a, b in zip(jrows, trows):
        assert set(a) == set(b)


@pytest.mark.parametrize("mode", ["loop", "stacked", "ppo"])
def test_block_equals_ticks(mode):
    """make_block over K = 3 ticks against 3 ticks called one by one with
    `k, sub = split(k)`: the same states, train states and metric rows, bit
    for bit; the best values, their tick index and the snapshots those of
    the tracked ticks."""
    cfg = EnvConfig(num_worlds=4, init_agents=8, max_agents=32)
    models = [ActorCritic.from_generator(SpeciesNetGenerator(cfg.obs_dim, 6, 32,
                                                             cfg.hidden_state_dim, seed=0))
              for _ in range(NS)]
    stacked = mode == "stacked"
    if mode == "ppo":
        tick, opt = ppo.make_ppo_trainer(models, cfg, rollout_len=2, num_minibatches=2,
                                         learner_slots_per_class=4)
    else:
        tick, opt = a2c.make_train_tick(models, cfg, learner_slots_per_class=4, stacked=stacked)
    ts0 = (a2c.init_stacked_train_state if stacked else a2c.init_train_states)(
        models, rng.key(2), opt)
    view = (lambda ts, sp: ts) if stacked else (lambda ts, sp: ts[sp])
    K, key = 3, rng.key(11)
    best_in = torch.tensor([[0.5, float("inf"), -1.0, float("inf")]] * 3)
    block = cli.make_block(tick, K, NS, view, track_best=mode != "ppo")
    state, ts, ms, bv, snaps, bidx, names = block(init_state(cfg, 1, "cpu"), ts0, key, best_in)

    s, t, k = init_state(cfg, 1, "cpu"), ts0, key
    rows, history = [], []
    for _ in range(K):
        k, sub = rng.split(k, 2)
        s, t, m = tick(s, t, sub)
        rows.append(torch.stack([m[n].to(torch.float32) for n in sorted(m)]))
        history.append((t, m))
    assert names == sorted(history[0][1])
    assert torch.equal(ms, torch.stack(rows))
    for f in FIELDS:
        assert torch.equal(getattr(state, f), getattr(s, f)), f
    for a, b in zip(jax.tree.leaves(ts), jax.tree.leaves(t)):
        assert torch.equal(a, b)
    if mode == "ppo":
        assert snaps == [] and bool((bidx == -1).all()) and torch.equal(bv, best_in)
        return
    for mi, metric in enumerate(cli.BEST_METRICS):
        for sp in range(NS):
            vals = [float(m[f"species_{sp + 1}_{metric}"]) for _, m in history]
            lo = float(best_in[mi, sp])
            want_i = -1
            for i, v in enumerate(vals):
                if v < lo:
                    lo, want_i = v, i
            assert int(bidx[mi, sp]) == want_i and float(bv[mi, sp]) == lo, (metric, sp)
            want_ts = view(ts0 if want_i < 0 else history[want_i][0], sp)
            for a, b in zip(jax.tree.leaves(snaps[mi][sp]), jax.tree.leaves(want_ts)):
                assert torch.equal(a, b), (metric, sp)
    assert int((bidx >= 0).sum()) > 0 and int((bidx == -1).sum()) > 0
