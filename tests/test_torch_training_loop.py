"""The port's training CLI on the CPU: create a universe, train, restore
and go on; the same universe and metric names as the JAX package's CLI;
unported modes refused."""

import json
import os

import numpy as np
import pytest

from madrona_bots_tpu.learn import training_loop as jax_cli
from madrona_bots_tpu_torch.learn import training_loop as cli

BASE = ["--num_worlds", "8", "--hidden_dim", "32", "--seed", "5"]


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


@pytest.mark.parametrize("flags", [["--algo", "ppo"], ["--stacked"], ["--use_mesh"],
                                   ["--ticks_per_block", "4"]])
def test_unported_modes_refused(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="not ported"):
        cli.main(BASE + ["--device", "cpu", "--model_save_dir", str(tmp_path),
                         "--create_universe"] + flags)
    assert not os.path.exists(tmp_path / "universe_luc")


def test_universe_existence_checks(port_run, tmp_path):
    d, _ = port_run
    with pytest.raises(FileExistsError, match="already exists"):
        cli.main(BASE + ["--device", "cpu", "--model_save_dir", d, "--universe_id", "u",
                         "--create_universe"])
    with pytest.raises(FileNotFoundError, match="does not exist"):
        cli.main(BASE + ["--device", "cpu", "--model_save_dir", str(tmp_path),
                         "--universe_id", "none"])
