"""The port's CheckpointManager: file names, retention, highest-epoch
restore, and checkpoints that carry between the two packages unchanged."""

import os

import jax
import numpy as np
import pytest
import torch

from madrona_bots_tpu.learn.a2c import make_optimizer as jax_make_optimizer
from madrona_bots_tpu.learn.ckpt import CheckpointManager as JaxCkpt
from madrona_bots_tpu.models import ActorCritic as JaxAC
from madrona_bots_tpu.models import SpeciesNetGenerator as JaxGen
from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.learn.a2c import AdamState, make_optimizer
from madrona_bots_tpu_torch.learn.ckpt import CheckpointManager
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator


def port_model(seed=0):
    model = ActorCritic(SpeciesNetGenerator(69, 6, 32, 16, seed=seed).sample_config())
    params = model.flatten(model.init(rng.key(seed)))
    r = np.random.default_rng(seed)
    opt = AdamState(torch.tensor(7, dtype=torch.int32),
                    torch.from_numpy(r.normal(size=model.num_params).astype(np.float32)),
                    torch.from_numpy(r.random(model.num_params).astype(np.float32)))
    return model, params, opt


def test_names_and_retention(tmp_path):
    model, params, opt = port_model()
    ck = CheckpointManager(str(tmp_path))
    for epoch in (0, 1, 2):
        ck.save(model, params, opt, "species_1", epoch)
    ck.save(model, params, opt, "species_1", 1, metric_name="total_loss")
    ck.save(model, params, opt, "species_1", 2, metric_name="actor_loss")
    ck.save(model, params, opt, "species_1", 3, metric_name="total_loss")
    assert sorted(os.listdir(tmp_path / "species_1")) == [
        "best_actor_loss_epoch_2.ckpt.npz", "best_total_loss_epoch_3.ckpt.npz",
        "latest_model_epoch_2.ckpt.npz"]


def test_highest_epoch_restore_round_trips(tmp_path):
    model, params, opt = port_model(1)
    ck = CheckpointManager(str(tmp_path))
    d = tmp_path / "species_2"
    d.mkdir()
    ck.save(model, params, opt, "species_2", 12)
    os.link(d / "latest_model_epoch_12.ckpt.npz", d / "latest_model_epoch_9.ckpt.npz")
    m2, p2, o2, epoch = ck.load(ActorCritic, make_optimizer(), "species_2")
    assert epoch == 12 and m2.get_config() == model.get_config()
    assert torch.equal(p2, params)
    assert all(torch.equal(a, b) for a, b in zip(o2, opt))
    assert o2.count.dtype == torch.int32
    with pytest.raises(FileNotFoundError):
        ck.load(ActorCritic, make_optimizer(), "species_2", metric_name="critic_loss")


def test_jax_checkpoint_loads_into_port_and_back(tmp_path):
    """A JAX-written checkpoint loads into the port with equal arrays; the
    port writes it back and the JAX package loads equal arrays."""
    jm = JaxAC(JaxGen(69, 6, 32, 16, seed=4).sample_config())
    jp = jm.init(jax.random.key(4))
    jopt = jax_make_optimizer(3e-4)
    jo = jopt.init(jp)
    jo = jax.tree.map(lambda x: x + 1 if x.ndim == 0 else x + 0.25, jo)
    JaxCkpt(str(tmp_path / "a")).save(jm, jp, jo, "species_3", 5, metric_name="critic_loss")

    model, params, opt, epoch = CheckpointManager(str(tmp_path / "a")).load(
        ActorCritic, make_optimizer(), "species_3", metric_name="critic_loss")
    assert epoch == 5 and model.get_config() == jm.get_config()
    for a, b in zip(jax.tree.leaves(jp), model.unflatten(params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jax.tree.leaves(jo), opt):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    CheckpointManager(str(tmp_path / "b")).save(model, params, opt, "species_3", 6)
    jm2, jp2, jo2, jepoch = JaxCkpt(str(tmp_path / "b")).load(JaxAC, jopt, "species_3")
    assert jepoch == 6 and jm2.get_config() == jm.get_config()
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(jp2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(jo), jax.tree.leaves(jo2)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(tmp_path / "a" / "species_3" / "best_critic_loss_epoch_5.ckpt.npz") as a, \
            np.load(tmp_path / "b" / "species_3" / "latest_model_epoch_6.ckpt.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


def test_load_rejects_mismatched_file(tmp_path):
    model, params, opt = port_model(2)
    ck = CheckpointManager(str(tmp_path))
    ck.save(model, params, AdamState(opt.count, opt.mu[:-1], opt.nu[:-1]), "species_1", 1)
    with pytest.raises(ValueError):
        ck.load(ActorCritic, make_optimizer(), "species_1")
