"""Whole-tick parity: the port's env.step trajectories under random actions
match the JAX env.step, the port reproduces tests/golden_trajectory.json,
and construct_obs matches (quirk_compat included)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_bots_tpu import EnvConfig as JaxConfig
from madrona_bots_tpu import init_state as jax_init_state
from madrona_bots_tpu.env import env as jenv
from madrona_bots_tpu.learn.obs import construct_obs as jax_construct_obs
from madrona_bots_tpu.learn.obs import species_mask as jax_species_mask
from madrona_bots_tpu_torch import EnvConfig, init_state, rollout
from madrona_bots_tpu_torch.env import env as tenv
from madrona_bots_tpu_torch.env.state import state_from_numpy, state_to_numpy
from madrona_bots_tpu_torch.learn.obs import construct_obs, species_mask
from test_oracle_parity import _golden_digests, random_actions
from test_torch_state import assert_arrays_equal, jax_arrays

KW = dict(num_worlds=2, init_agents=32, max_agents=64)
TOL_FIELDS = ("surrounding", "prev_surrounding")


@pytest.mark.parametrize("seed", [0, 7])
def test_trajectory_matches_jax(seed):
    jcfg, tcfg = JaxConfig(**KW), EnvConfig(**KW)
    js = jax_init_state(jax.random.key(seed), jcfg)
    ts = init_state(tcfg, seed, device="cpu")
    rng = np.random.default_rng(seed)
    for t in range(30):
        acts = random_actions(rng, 2, 64)
        js = jenv.step(jenv.set_actions(js, jnp.array(acts)), jcfg)
        ts = tenv.step(tenv.set_actions(ts, torch.from_numpy(acts)), tcfg)
        if t % 3 == 0:
            js = jenv.shift_observations(js, jcfg)
            ts = tenv.shift_observations(ts, tcfg)
        assert_arrays_equal(jax_arrays(js), state_to_numpy(ts), f"step {t}", TOL_FIELDS)


def test_golden_trajectory():
    """The port reproduces the JAX package's frozen 50-step digest trace."""
    golden = json.load(open(os.path.join(os.path.dirname(__file__),
                                         "golden_trajectory.json")))
    cfg = EnvConfig(**KW)
    state = init_state(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    for want in golden:
        acts = random_actions(rng, 2, 64)
        state = tenv.step(tenv.set_actions(state, torch.from_numpy(acts)), cfg)
        row = _golden_digests(state)
        for k, v in want.items():
            assert k == "t" or row[k] == v, (want["t"], k)


@pytest.fixture(scope="module")
def stepped_pair():
    jcfg, tcfg = JaxConfig(**KW), EnvConfig(**KW)
    js = jax_init_state(jax.random.key(3), jcfg)
    ts = init_state(tcfg, 3, device="cpu")
    rng = np.random.default_rng(3)
    for t in range(8):
        acts = random_actions(rng, 2, 64)
        js = jenv.step(jenv.set_actions(js, jnp.array(acts)), jcfg)
        ts = tenv.step(tenv.set_actions(ts, torch.from_numpy(acts)), tcfg)
        if t == 4:
            js = jenv.shift_observations(js, jcfg)
            ts = tenv.shift_observations(ts, tcfg)
    return js, ts, jcfg, tcfg


@pytest.mark.parametrize("prev", [False, True])
@pytest.mark.parametrize("quirk_compat", [False, True])
def test_construct_obs_matches(stepped_pair, prev, quirk_compat):
    js, ts, jcfg, tcfg = stepped_pair
    want = np.asarray(jax_construct_obs(js, jcfg, prev=prev, quirk_compat=quirk_compat))
    got = construct_obs(ts, tcfg, prev=prev, quirk_compat=quirk_compat).numpy()
    assert got.shape == (2, 64, tcfg.obs_dim) and got.dtype == np.float32
    cols = np.arange(tcfg.obs_dim)
    surr = cols >= tcfg.obs_dim - 2
    np.testing.assert_array_equal(want[..., ~surr].view(np.uint32),
                                  got[..., ~surr].view(np.uint32))
    np.testing.assert_allclose(got[..., surr], want[..., surr], rtol=1e-5, atol=1e-4)


def test_construct_obs_bf16_and_species_mask(stepped_pair):
    js, ts, jcfg, tcfg = stepped_pair
    want = np.asarray(jax_construct_obs(js, jcfg, dtype=jnp.bfloat16).astype(jnp.float32))
    got = construct_obs(ts, tcfg, dtype=torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    np.testing.assert_array_equal(want[..., :-2], got[..., :-2])
    for sp in range(1, 5):
        np.testing.assert_array_equal(np.asarray(jax_species_mask(js, sp)),
                                      species_mask(ts, sp).numpy())


def test_state_carried_from_jax_steps_on():
    """A JAX state carried across with state_from_numpy steps on in the port
    exactly as in the JAX package."""
    jcfg, tcfg = JaxConfig(**KW), EnvConfig(**KW)
    js = jax_init_state(jax.random.key(9), jcfg)
    rng = np.random.default_rng(9)
    for _ in range(5):
        js = jenv.step(jenv.set_actions(js, jnp.array(random_actions(rng, 2, 64))), jcfg)
    ts = state_from_numpy(jax_arrays(js), device="cpu")
    for t in range(5):
        acts = random_actions(rng, 2, 64)
        js = jenv.step(jenv.set_actions(js, jnp.array(acts)), jcfg)
        ts = tenv.step(tenv.set_actions(ts, torch.from_numpy(acts)), tcfg)
        assert_arrays_equal(jax_arrays(js), state_to_numpy(ts), f"step {t}", TOL_FIELDS)


def test_rollout_with_generator_actions():
    cfg = EnvConfig(num_worlds=2, init_agents=8, max_agents=16)
    gen = torch.Generator().manual_seed(0)

    def policy(state):
        a = torch.randint(0, 6, state.alive.shape, generator=gen)
        return torch.nn.functional.one_hot(a, 6).to(torch.int32)

    state = rollout(init_state(cfg, 1, device="cpu"), 5, policy, cfg)
    assert int(state.step_count) == 5
    assert bool(state.alive.any())
    assert construct_obs(state, cfg).isfinite().all()
