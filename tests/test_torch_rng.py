"""The port's threefry counter RNG reproduces jax.random's bits on the env's
call patterns: world keys, initial positions, food draws, respawn draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_bots_tpu.config import EnvConfig as JaxConfig
from madrona_bots_tpu.env import systems as jsys
from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.config import SALT_FOOD, SALT_INIT, SALT_WORLD, EnvConfig
from madrona_bots_tpu_torch.env import systems as tsys


def _world_keys(seed, W):
    salted = jax.random.fold_in(jax.random.key(seed), SALT_WORLD)
    jk = jax.vmap(lambda w: jax.random.fold_in(salted, w))(jnp.arange(W))
    tk = rng.fold_in(rng.fold_in(rng.key(seed), SALT_WORLD)[None], torch.arange(W))
    return jk, tk


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_fold_in_world_keys(seed):
    jk, tk = _world_keys(seed, 16)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jk)),
                                  tk.numpy().astype(np.uint32))


@pytest.mark.parametrize("shape", [(32, 2), (5,), ()])
def test_uniform_init_positions(shape):
    jk, tk = _world_keys(3, 8)
    want = jax.vmap(lambda k: jax.random.uniform(
        jax.random.fold_in(k, SALT_INIT), shape, jnp.float32))(jk)
    got = rng.uniform(rng.fold_in(tk, SALT_INIT), shape)
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  got.numpy().view(np.uint32))


@pytest.mark.parametrize("t", [0, 1, 37, 2**31 - 1])
def test_randint_food_draw_pattern(t):
    jk, tk = _world_keys(11, 64)
    hi = jnp.array([8, 6, 16, 16])

    def draws(wkey):
        k = jax.random.fold_in(jax.random.fold_in(wkey, t), SALT_FOOD)
        return (jax.random.randint(jax.random.fold_in(k, 0), (), 0, 10),
                jax.random.randint(jax.random.fold_in(k, 1), (), 1, 3),
                jax.random.randint(jax.random.fold_in(k, 2), (4,), 0, hi))

    gate, n, per = jax.vmap(draws)(jk)
    k = rng.fold_in(rng.fold_in(tk, torch.tensor(t, dtype=torch.int32)), SALT_FOOD)
    np.testing.assert_array_equal(np.asarray(gate), rng.randint(rng.fold_in(k, 0), (), 0, 10).numpy())
    np.testing.assert_array_equal(np.asarray(n), rng.randint(rng.fold_in(k, 1), (), 1, 3).numpy())
    np.testing.assert_array_equal(
        np.asarray(per),
        rng.randint(rng.fold_in(k, 2), (4,), 0, torch.tensor([8, 6, 16, 16])).numpy())


@pytest.mark.parametrize("span", [(0, 1), (-5, 70000), (3, 3), (0, 2**31 - 1)])
def test_randint_wide_spans(span):
    k = jax.random.fold_in(jax.random.key(9), 4)
    want = jax.random.randint(k, (300,), *span)
    got = rng.randint(rng.fold_in(rng.key(9), 4), (300,), *span)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("kw", [{}, dict(num_species=2, init_agents=12, max_agents=24)])
def test_respawn_draws(kw):
    jcfg, tcfg = JaxConfig(num_worlds=8, **kw), EnvConfig(num_worlds=8, **kw)
    jk, tk = _world_keys(5, 8)
    for t in (0, 9):
        want = np.asarray(jsys.respawn_draws(jk, jnp.int32(t), jcfg))
        got = tsys.respawn_draws(tk, torch.tensor(t, dtype=torch.int32), tcfg).numpy()
        np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


def test_food_spawn_matches():
    cfg_kw = dict(num_worlds=64, total_allowed_food=6)
    jcfg, tcfg = JaxConfig(**cfg_kw), EnvConfig(**cfg_kw)
    jk, tk = _world_keys(2, 64)
    r = np.random.default_rng(2)
    C, P = tcfg.num_chunks, tcfg.max_food_packages
    count = (r.random((64, C, P)) < 0.5).astype(np.int32)
    cell = r.integers(0, 16, (64, C, P, 2)).astype(np.int32)
    num = np.minimum(count.sum(axis=(1, 2)), 7).astype(np.int32)
    for t in range(12):
        want = jsys.food_spawn(jnp.array(count), jnp.array(cell), jnp.array(num),
                               jk, jnp.int32(t), jcfg)
        got = tsys.food_spawn(torch.from_numpy(count), torch.from_numpy(cell),
                              torch.from_numpy(num), tk,
                              torch.tensor(t, dtype=torch.int32), tcfg)
        for w_, g_ in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w_), g_.numpy())
        count, cell, num = (np.array(v) for v in want)


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 9])
def test_split_matches(seed):
    for num in (2, 4, 7):
        want = jax.random.key_data(jax.random.split(jax.random.key(seed), num))
        np.testing.assert_array_equal(np.asarray(want),
                                      rng.split(rng.key(seed), num).numpy().astype(np.uint32))


@pytest.mark.parametrize("fan_in", [16, 32, 69, 128])
def test_uniform_with_bounds_matches(fan_in):
    """`jax.random.uniform(k, shape, f32, -b, b)`, bit for bit (XLA fuses
    u * span + minval into one FMA)."""
    b = 1.0 / jnp.sqrt(jnp.float32(fan_in))
    want = jax.random.uniform(jax.random.key(fan_in), (fan_in, 40), jnp.float32, -b, b)
    tb = torch.tensor(np.float32(b))
    got = rng.uniform(rng.key(fan_in), (fan_in, 40), -tb, tb)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_categorical_matches_jitted_jax(seed):
    """Sampled actions of the A2C tick's call pattern (fold_in(key, s) per
    species, [N, 6] logits) equal the jitted jax.random.categorical's; the
    Gumbel noise itself is held within a few ulp (XLA:CPU's log and
    torch's may differ in the last bit)."""
    r = np.random.default_rng(seed)
    logits = (r.normal(size=(4096, 6)) * 3).astype(np.float32)
    for s in range(4):
        jk = jax.random.fold_in(jax.random.key(seed), s)
        tk = rng.fold_in(rng.key(seed), s)
        want = jax.jit(jax.random.categorical)(jk, jnp.asarray(logits))
        got = rng.categorical(tk, torch.from_numpy(logits))
        assert int((np.asarray(want) != got.numpy()).sum()) == 0
        g_want = jax.jit(lambda k: jax.random.gumbel(k, (4096, 6)))(jk)
        np.testing.assert_allclose(rng.gumbel(tk, (4096, 6)).numpy(), np.asarray(g_want),
                                   rtol=1e-6, atol=1e-6)
