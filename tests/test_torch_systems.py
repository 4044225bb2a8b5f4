"""The port's systems step (ops/step_cuda.py's plain composition on the
CPU) against the JAX spec path `step_systems(use_pallas=False)`: every
field exact except `surrounding` (rtol 1e-5, atol 1e-4), on the cases of
tests/test_step_pallas.py, all 8 reward settings and the D1/D3/D4 quirks;
one case also against the JAX systems kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_bots_tpu import EnvConfig as JaxConfig
from madrona_bots_tpu import init_state as jax_init_state
from madrona_bots_tpu.config import RewardSetting as JaxReward
from madrona_bots_tpu.env import env as jenv
from madrona_bots_tpu.env import systems as jsys
from madrona_bots_tpu.ops.step_pallas import fused_step_systems
from madrona_bots_tpu_torch.config import EnvConfig, RewardSetting
from madrona_bots_tpu_torch.env import env as tenv
from madrona_bots_tpu_torch.env import systems as tsys
from madrona_bots_tpu_torch.env.state import state_from_numpy, state_to_numpy
from madrona_bots_tpu_torch.ops import step_cuda
from test_torch_state import assert_arrays_equal, jax_arrays

EXACT_FIELDS = [
    "pos", "heading", "health", "alive", "species", "stats", "hidden",
    "action", "reward", "finder", "sensor_depth", "sensor_semantic",
    "prev_sensor_depth", "prev_sensor_semantic", "prev_species", "prev_pos",
    "prev_health", "prev_reward", "prev_action", "prev_stats", "prev_hidden",
    "food_count", "food_cell", "num_food", "species_counts",
    "species_rewards", "step_count",
]
TOL_FIELDS = ("surrounding", "prev_surrounding")

# The JAX package runs its step under jit (env.step, rollout's scan), where
# XLA:CPU rewrites and fuses the reward arithmetic; the port reproduces those
# jitted bits, so the reference phases are jitted here too.
jax_step_systems = jax.jit(jenv.step_systems, static_argnums=(1,))
jax_sensor_pass = jax.jit(jenv.sensor_pass, static_argnums=(1,))


def random_actions(rng, W, A, heavy=False):
    acts = np.zeros((W, A, 6), np.int32)
    acts[np.arange(W)[:, None], np.arange(A)[None, :], rng.integers(0, 6, (W, A))] = 1
    if heavy:
        acts[:, :, 4] |= rng.integers(0, 2, (W, A)).astype(np.int32)
        acts[:, :, 5] |= rng.integers(0, 2, (W, A)).astype(np.int32)
    return acts


def run_pair(kw, seed, steps, heavy, jax_state=None):
    """`steps` systems steps, each followed by the sensor pass, through both
    packages from the same state and actions; compares after every step."""
    jcfg, tcfg = JaxConfig(**kw), EnvConfig(**kw)
    js = jax_state if jax_state is not None else jax_init_state(jax.random.key(seed), jcfg)
    ts = state_from_numpy(jax_arrays(js), device="cpu")
    rng = np.random.default_rng(seed)
    for t in range(steps):
        acts = random_actions(rng, jcfg.num_worlds, jcfg.max_agents, heavy(t))
        js = jax_sensor_pass(jax_step_systems(jenv.set_actions(js, jnp.array(acts)), jcfg), jcfg)
        ts = tenv.sensor_pass(tenv.step_systems(tenv.set_actions(ts, torch.from_numpy(acts)), tcfg), tcfg)
        assert_arrays_equal(jax_arrays(js), state_to_numpy(ts), f"step {t}", TOL_FIELDS)
    return js, ts


@pytest.mark.parametrize("seed,heavy", [(0, False), (3, True)])
def test_matches_spec(seed, heavy):
    run_pair(dict(num_worlds=4, init_agents=32, max_agents=64), seed, 20,
             lambda t: heavy)


def test_odd_shapes():
    run_pair(dict(num_worlds=3, init_agents=8, max_agents=16, num_chunks_x=5,
                  num_chunks_y=3, total_allowed_food=11), 13, 12,
             lambda t: t % 2 == 0)


def test_two_species():
    run_pair(dict(num_worlds=2, init_agents=12, max_agents=24, num_species=2),
             21, 10, lambda t: True)


def _stacked_state():
    cfg = JaxConfig(num_worlds=2, init_agents=16, max_agents=32)
    s = jax_init_state(jax.random.key(5), cfg)
    fc = np.zeros_like(np.asarray(s.food_count))
    fcell = np.zeros_like(np.asarray(s.food_cell))
    fc[0, 0, :4] = 1
    fc[1, 1, :5] = 1
    fcell[1, 1, :5] = (3, 2)
    pos = np.zeros_like(np.asarray(s.pos))
    pos[0] = (0.5, 0.5)
    pos[1] = (19.5, 2.5)
    return s.replace(food_count=jnp.array(fc), food_cell=jnp.array(fcell),
                     num_food=jnp.array(fc.sum(axis=(1, 2)), dtype=jnp.int32),
                     pos=jnp.array(pos), action=jnp.zeros_like(s.action))


def test_stacked_packages():
    """3+ packages on one cell with every agent standing on it."""
    js, ts = run_pair(dict(num_worlds=2, init_agents=16, max_agents=32), 5, 1,
                      lambda t: False, jax_state=_stacked_state())
    eaten = ts.stats[..., 2].sum(dim=1)
    assert eaten[0] >= 4 and eaten[1] >= 5, eaten


def test_matches_jax_systems_kernel_interpret():
    """One step of the JAX Pallas systems kernel (interpret mode) against
    the port's systems step. Under jit, XLA fuses the JAX fused path's
    reward chain differently from its spec path (a few ulp apart; the port
    reproduces the spec path), so `reward` and `species_rewards` are held to
    the oracle tolerance of tests/test_oracle_parity.py here; every other
    field is exact."""
    kw = dict(num_worlds=2, init_agents=16, max_agents=32)
    js = _stacked_state()
    ts = state_from_numpy(jax_arrays(js), device="cpu")
    rng = np.random.default_rng(8)
    acts = random_actions(rng, 2, 32, heavy=True)
    jk = jax.jit(fused_step_systems, static_argnums=(1, 2))(
        jenv.set_actions(js, jnp.array(acts)), JaxConfig(**kw), True)
    tk = tenv.step_systems(tenv.set_actions(ts, torch.from_numpy(acts)), EnvConfig(**kw))
    assert_arrays_equal(jax_arrays(jk), state_to_numpy(tk), "interpret",
                        TOL_FIELDS + ("reward", "species_rewards"))


@pytest.mark.parametrize("setting", list(RewardSetting))
def test_reward_settings(setting):
    """reward_system for each setting on random stats, health and positions,
    with species rewards from species_info's expression."""
    kw = dict(num_worlds=4, init_agents=32, max_agents=64, reward_setting=setting)
    jcfg = JaxConfig(**{**kw, "reward_setting": JaxReward(int(setting))})
    tcfg = EnvConfig(**kw)
    r = np.random.default_rng(int(setting))
    W, A = 4, 64
    alive = r.random((W, A)) < 0.7
    species = np.where(alive, np.arange(A) % 4 + 1, 0).astype(np.int32)
    health = np.where(alive, r.integers(1, 160, (W, A)), 0).astype(np.int32)
    stats = r.integers(0, 2, (W, A, 4)).astype(np.int32)
    pos = (r.random((W, A, 2)) * np.array([127.0, 95.0])).astype(np.float32)
    counts = r.integers(0, 40, (W, 4)).astype(np.int32)
    hsum = (counts * r.integers(1, 150, (W, 4))).astype(np.int32)
    j_avg = jax.jit(lambda c, h: jnp.where(c > 0, h.astype(jnp.float32) / c.astype(jnp.float32),
                                           0.0))(counts, hsum)
    j_rewards = jax.jit(lambda c, a: c.astype(jnp.float32) / jnp.float32(32)
                        + a / 100.0 - 2.0)(jnp.array(counts), j_avg)
    t_rewards = tsys.species_rewards(torch.from_numpy(counts), torch.from_numpy(hsum), tcfg)
    np.testing.assert_array_equal(np.asarray(j_rewards), t_rewards.numpy())
    want = jax.jit(jsys.reward_system, static_argnums=6)(
        jnp.array(species), jnp.array(health), jnp.array(alive), j_rewards,
        jnp.array(stats), jnp.array(pos), jcfg)
    got = tsys.reward_system(torch.from_numpy(species), torch.from_numpy(health),
                             torch.from_numpy(alive), t_rewards,
                             torch.from_numpy(stats), torch.from_numpy(pos), tcfg)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("setting", [RewardSetting.SETTING_2, RewardSetting.SETTING_7B])
def test_reward_settings_in_step(setting):
    kw = dict(num_worlds=2, init_agents=16, max_agents=32, reward_setting=setting)
    jkw = {**kw, "reward_setting": JaxReward(int(setting))}
    jcfg = JaxConfig(**jkw)
    js = jax_init_state(jax.random.key(4), jcfg)
    ts = state_from_numpy(jax_arrays(js), device="cpu")
    rng = np.random.default_rng(4)
    for t in range(6):
        acts = random_actions(rng, 2, 32, heavy=True)
        js = jenv.step(jenv.set_actions(js, jnp.array(acts)), jcfg)
        ts = tenv.step(tenv.set_actions(ts, torch.from_numpy(acts)), EnvConfig(**kw))
        assert_arrays_equal(jax_arrays(js), state_to_numpy(ts), f"step {t}", TOL_FIELDS)


@pytest.mark.parametrize("quirk", ["quirk_d1_stale_finder", "quirk_d3_oob_reward"])
def test_quirks_in_step(quirk):
    run_pair(dict(num_worlds=2, init_agents=16, max_agents=32, **{quirk: True}),
             6, 8, lambda t: True)


def test_quirk_d4_shift_typo():
    kw = dict(num_worlds=2, init_agents=16, max_agents=32, quirk_d4_shift_typo=True)
    js, ts = run_pair(kw, 2, 3, lambda t: True)
    js = jenv.shift_observations(js, JaxConfig(**kw))
    ts = tenv.shift_observations(ts, EnvConfig(**kw))
    assert_arrays_equal(jax_arrays(js), state_to_numpy(ts), "shift", TOL_FIELDS)
    np.testing.assert_array_equal(ts.prev_stats[..., 1].numpy(), ts.stats[..., 0].numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_claim_slots_matches(seed):
    r = np.random.default_rng(seed)
    free = r.random((6, 32)) < 0.4
    active = r.random((6, 20)) < 0.5
    want_slot, _ = jsys.claim_slots(jnp.array(free), jnp.array(active))
    got_slot = tsys.claim_slots(torch.from_numpy(free), torch.from_numpy(active))
    np.testing.assert_array_equal(np.asarray(want_slot), got_slot.numpy())


def test_systems_wrapper_checks_inputs_and_counts_no_cpu_launch():
    """The whole-step wrapper takes the plain path on a CPU state and counts
    no launch; a field of the wrong shape or dtype raises."""
    cfg = EnvConfig(num_worlds=2, init_agents=16, max_agents=32)
    s = state_from_numpy(jax_arrays(_stacked_state()), device="cpu")
    before = step_cuda.launches
    got = step_cuda.step_systems_cuda(s.clone(), cfg)
    want = step_cuda.step_systems_plain(s.clone(), cfg)
    assert_arrays_equal(state_to_numpy(want), state_to_numpy(got), "cpu wrapper")
    assert step_cuda.launches == before
    with pytest.raises(ValueError, match="food_cell"):
        step_cuda.step_systems_cuda(s.replace(food_cell=s.food_cell[..., :1]), cfg)
    with pytest.raises(ValueError, match="hidden"):
        step_cuda.step_systems_cuda(s.replace(hidden=s.hidden.double()), cfg)
