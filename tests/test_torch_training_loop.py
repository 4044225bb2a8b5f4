"""The port's training CLI on the CPU: create a universe, train, restore
and go on (A2C and PPO); the same universe and metric names as the JAX
package's CLI; PPO universes load in either package; --use_mesh in one
process writes what the run without it writes. Stacked and block modes:
tests/test_torch_block.py."""

import json
import os
import shutil

import jax
import numpy as np
import pytest

from madrona_bots_tpu.learn import training_loop as jax_cli
from madrona_bots_tpu_torch.learn import training_loop as cli

BASE = ["--num_worlds", "8", "--hidden_dim", "32", "--seed", "5"]
PPO = ["--algo", "ppo", "--rollout_len", "2"]


def files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def metric_rows(save_dir, uid):
    with open(os.path.join(save_dir, f"universe_{uid}-r8.metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port"))
    cli.main(BASE + ["--device", "cpu", "--model_save_dir", d, "--universe_id", "u",
                     "--num_epochs", "3", "--create_universe"])
    after_create = files(d)
    cli.main(BASE + ["--device", "cpu", "--model_save_dir", d, "--universe_id", "u",
                     "--num_epochs", "2"])
    return d, after_create


def test_create_then_restore(port_run, capsys):
    d, after_create = port_run
    for sp in range(1, 5):
        assert f"universe_u/species_{sp}/latest_model_epoch_3.ckpt.npz" in after_create
        names = os.listdir(os.path.join(d, "universe_u", f"species_{sp}"))
        assert "latest_model_epoch_5.ckpt.npz" in names
        assert [n for n in names if n.startswith("latest")] == ["latest_model_epoch_5.ckpt.npz"]
        assert any(n.startswith("best_total_loss_epoch_") for n in names)
    rows = metric_rows(d, "u")
    assert [r["epoch"] for r in rows] == [1, 2, 3, 4, 5]
    for r in rows:
        assert all(np.isfinite(v) for v in r.values() if isinstance(v, float))


def test_universe_and_metric_keys_match_jax_cli(port_run, tmp_path):
    """`--create_universe --seed 5` writes the same epoch-0 universe in both
    packages, and one epoch logs the same metric names."""
    d, _ = port_run
    j = str(tmp_path / "jax")
    jax_cli.main(BASE + ["--model_save_dir", j, "--universe_id", "u", "--num_epochs", "1",
                         "--ckpt_every", "100", "--create_universe"])
    t = str(tmp_path / "port")
    cli.main(BASE + ["--device", "cpu", "--model_save_dir", t, "--universe_id", "u",
                     "--num_epochs", "1", "--ckpt_every", "100", "--create_universe"])
    for sp in range(1, 5):
        a = os.path.join(j, "universe_u", f"species_{sp}", "latest_model_epoch_0.ckpt.npz")
        b = os.path.join(t, "universe_u", f"species_{sp}", "latest_model_epoch_0.ckpt.npz")
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    assert set(metric_rows(j, "u")[0]) - {"_t"} == set(metric_rows(t, "u")[0]) - {"_t"}
    assert set(metric_rows(d, "u")[0]) == set(metric_rows(t, "u")[0])


@pytest.mark.parametrize("flags", [["--use_mesh"], ["--use_mesh"] + PPO,
                                   ["--use_mesh", "--stacked", "--ticks_per_block", "2"]])
def test_unported_modes_refused(tmp_path, flags, capsys):
    """No mode is refused any more: --use_mesh without a launcher runs a
    group of one process in this process, prints the JAX CLI's mesh line,
    destroys the group, and writes the files of the run without it, in
    bits (metrics but their clock readings), with A2C, PPO and the
    stacked update in blocks."""
    import torch.distributed as dist

    for d, extra in (("mesh", flags), ("plain", [f for f in flags if f != "--use_mesh"])):
        cli.main(BASE + ["--device", "cpu", "--model_save_dir", str(tmp_path / d),
                         "--num_epochs", "2", "--create_universe"] + extra)
    assert "mesh: 1 devices, worlds sharded" in capsys.readouterr().out
    assert not dist.is_initialized()
    assert files(tmp_path / "mesh") == files(tmp_path / "plain")
    for name in files(tmp_path / "mesh"):
        if name.endswith(".npz"):
            with np.load(tmp_path / "mesh" / name) as a, np.load(tmp_path / "plain" / name) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
    clock = ("_t", "epoch_fps")
    assert ([{k: v for k, v in r.items() if k not in clock}
             for r in metric_rows(tmp_path / "mesh", "luc")]
            == [{k: v for k, v in r.items() if k not in clock}
                for r in metric_rows(tmp_path / "plain", "luc")])


def test_universe_existence_checks(port_run, tmp_path):
    d, _ = port_run
    with pytest.raises(FileExistsError, match="already exists"):
        cli.main(BASE + ["--device", "cpu", "--model_save_dir", d, "--universe_id", "u",
                         "--create_universe"])
    with pytest.raises(FileNotFoundError, match="does not exist"):
        cli.main(BASE + ["--device", "cpu", "--model_save_dir", str(tmp_path),
                         "--universe_id", "none"])



@pytest.fixture(scope="module")
def ppo_runs(tmp_path_factory):
    """The port's PPO CLI: create a universe with 2 epochs, restore it for 2
    more. The JAX CLI's PPO: create universe `z` with no epoch (its epoch-0
    files) and universe `p` with 1 epoch."""
    d = str(tmp_path_factory.mktemp("port_ppo"))
    cli.main(BASE + PPO + ["--device", "cpu", "--model_save_dir", d, "--universe_id", "p",
                           "--num_epochs", "2", "--create_universe"])
    after_create = files(d)
    cli.main(BASE + PPO + ["--device", "cpu", "--model_save_dir", d, "--universe_id", "p",
                           "--num_epochs", "2"])
    j = str(tmp_path_factory.mktemp("jax_ppo"))
    for uid, epochs in (("z", "0"), ("p", "1")):
        jax_cli.main(BASE + PPO + ["--model_save_dir", j, "--universe_id", uid,
                                   "--num_epochs", epochs, "--create_universe"])
    return d, after_create, j


def ckpt_file(root, uid, sp, epoch):
    return os.path.join(root, f"universe_{uid}", f"species_{sp}",
                        f"latest_model_epoch_{epoch}.ckpt.npz")


def test_ppo_create_then_restore(ppo_runs):
    d, after_create, _ = ppo_runs
    for sp in range(1, 5):
        assert f"universe_p/species_{sp}/latest_model_epoch_2.ckpt.npz" in after_create
        # PPO logs no A2C loss, so as in the JAX CLI no best-metric file is kept.
        assert os.listdir(os.path.join(d, "universe_p", f"species_{sp}")) == [
            "latest_model_epoch_4.ckpt.npz"]
        with np.load(ckpt_file(d, "p", sp, 4)) as z:
            assert int(z["o_0"]) == 4 * 8         # 8 Adam steps an iteration
    rows = metric_rows(d, "p")
    assert [r["epoch"] for r in rows] == [1, 2, 3, 4]
    for r in rows:
        assert all(np.isfinite(v) for v in r.values() if isinstance(v, float))
        assert r["env_steps"] == 2 * 8


def test_ppo_universe_and_metric_keys_match_jax_cli(ppo_runs, tmp_path):
    """`--algo ppo --create_universe --seed 5` writes the same epoch-0
    universe in both packages, and an iteration logs the same metric
    names."""
    d, _, j = ppo_runs
    t = str(tmp_path)
    cli.main(BASE + PPO + ["--device", "cpu", "--model_save_dir", t, "--universe_id", "z",
                           "--num_epochs", "0", "--create_universe"])
    assert files(os.path.join(t, "universe_z")) == files(os.path.join(j, "universe_z"))
    for sp in range(1, 5):
        with np.load(ckpt_file(t, "z", sp, 0)) as za, np.load(ckpt_file(j, "z", sp, 0)) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    assert set(metric_rows(j, "p")[0]) - {"_t"} == set(metric_rows(d, "p")[0]) - {"_t"}


def test_ppo_universe_loads_across_packages(ppo_runs, tmp_path):
    """The port restores the JAX CLI's trained PPO universe and trains on;
    the JAX CLI restores the port's, with the parameters and the Adam state
    of its files."""
    d, _, j = ppo_runs
    t = str(tmp_path)
    shutil.copytree(os.path.join(j, "universe_p"), os.path.join(t, "universe_p"))
    cli.main(BASE + PPO + ["--device", "cpu", "--model_save_dir", t, "--universe_id", "p",
                           "--num_epochs", "1"])
    for sp in range(1, 5):
        with np.load(ckpt_file(t, "p", sp, 2)) as z:
            assert int(z["o_0"]) == 2 * 8
    args = cli.build_parser().parse_args(BASE + PPO + ["--model_save_dir", d, "--universe_id",
                                                       "p", "--num_epochs", "0"])
    _, tstates = jax_cli.train(args)
    for sp, ts in enumerate(tstates, start=1):
        with np.load(ckpt_file(d, "p", sp, 4)) as z:
            leaves = jax.tree.leaves(ts.params)
            for i, x in enumerate(leaves):
                np.testing.assert_array_equal(np.asarray(x), z[f"p_{i}"])
            for i, x in enumerate(jax.tree.leaves(ts.opt_state)):
                np.testing.assert_array_equal(np.asarray(x), z[f"o_{i}"])
