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


def reference_format_pt(rtype: str, path, seed: int):
    """A `.pt` checkpoint in the reference's format (positional
    nn.Sequential keys under `a2c_nets.`), built here from torch nets: (the
    nets, the file)."""
    torch.manual_seed(seed)
    H, D, O = 24, 11, 6
    nets = dict(feature=torch.nn.Sequential(torch.nn.Linear(D, H), torch.nn.Linear(H, H),
                                            torch.nn.ELU()),
                recurrent=getattr(torch.nn, rtype)(H, H),
                actor=torch.nn.Sequential(torch.nn.Linear(H, H), torch.nn.ReLU(True),
                                          torch.nn.Linear(H, O)),
                critic=torch.nn.Sequential(torch.nn.Linear(H, H), torch.nn.ReLU(True),
                                           torch.nn.Linear(H, 1)))
    head = [{"type": "linear", "in_features": H, "out_features": H},
            {"type": "activation", "activation": "ReLU"}]
    config = {
        "layers": [{"type": "linear", "in_features": D, "out_features": H},
                   {"type": "linear", "in_features": H, "out_features": H},
                   {"type": "activation", "activation": "ELU"}],
        "actor": head + [{"type": "linear", "in_features": H, "out_features": O}],
        "critic": head + [{"type": "linear", "in_features": H, "out_features": 1}],
        "recurrent": {"type": rtype, "input_dim": H, "hidden_dim": H},
    }
    sd = {f"a2c_nets.{name}.{k}": v for name, mod in nets.items()
          for k, v in mod.state_dict().items()}
    torch.save({"model_state_dict": sd, "optimizer_state_dict": {}, "model_config": config},
               str(path))
    return nets


@pytest.mark.parametrize("rtype", ["GRU", "LSTM", "RNN"])
def test_import_torch_checkpoint(rtype, tmp_path):
    """A reference-format file imports into the port's net, whose one-step
    forward equals the torch nets' (f32 tolerance, as
    tests/test_ckpt_import.py holds the JAX import), with the parameters of
    the JAX package's import of the same file."""
    from madrona_bots_tpu.learn.ckpt import import_torch_checkpoint as jax_import
    from madrona_bots_tpu_torch.learn.ckpt import import_torch_checkpoint

    path = tmp_path / "latest_model_epoch_3.pt"
    nets = reference_format_pt(rtype, path, {"GRU": 0, "LSTM": 1, "RNN": 2}[rtype])
    model, params = import_torch_checkpoint(str(path), device="cpu")
    jmodel, jparams = jax_import(str(path))
    assert model.get_config() == jmodel.get_config()
    for a, b in zip(jax.tree.leaves(jparams), model.unflatten(params)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    r = np.random.default_rng(1)
    obs = torch.from_numpy(r.standard_normal((32, 11), dtype=np.float32))
    mem = torch.from_numpy(r.standard_normal((32, 24), dtype=np.float32))
    with torch.no_grad():
        seq, h0 = nets["feature"](obs)[None], mem[None]
        out, _ = nets["recurrent"](seq, (h0, torch.zeros_like(h0)) if rtype == "LSTM" else h0)
        shared = out[0]
        want = (nets["actor"](shared), nets["critic"](shared)[..., 0], shared)
        got = model(obs, mem, model.unflatten(params))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sim_state_round_trip_across_packages(writer, tmp_path):
    """A stepped sim state saved by one package loads in the other with
    every field equal in bits (world keys as their uint32 words), as
    tests/test_ckpt.py::test_sim_state_roundtrip holds the JAX package."""
    import jax.numpy as jnp
    from madrona_bots_tpu import EnvConfig as JaxConfig
    from madrona_bots_tpu import init_state as jax_init_state
    from madrona_bots_tpu import step as jax_step
    from madrona_bots_tpu.env.env import set_actions
    from madrona_bots_tpu.learn.ckpt import load_sim_state as jax_load
    from madrona_bots_tpu.learn.ckpt import save_sim_state as jax_save
    from madrona_bots_tpu_torch.env.state import state_from_numpy, state_to_numpy
    from madrona_bots_tpu_torch.learn.ckpt import load_sim_state, save_sim_state
    from test_torch_state import assert_arrays_equal, jax_arrays

    cfg = JaxConfig(num_worlds=2, init_agents=16, max_agents=32)
    acts = jnp.zeros((2, 32, 6), jnp.int32).at[..., 0].set(1)
    js = jax.jit(jax_step, static_argnums=1)(
        set_actions(jax_init_state(jax.random.key(0), cfg), acts), cfg)
    want = jax_arrays(js)
    path = str(tmp_path / "state.npz")
    if writer == "jax":
        jax_save(js, path)
        got = state_to_numpy(load_sim_state(path, device="cpu"))
    else:
        save_sim_state(state_from_numpy(want, device="cpu"), path)
        got = jax_arrays(jax_load(jax_init_state(jax.random.key(1), cfg), path))
    assert_arrays_equal(want, got, writer)
