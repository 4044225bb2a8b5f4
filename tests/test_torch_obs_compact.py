"""The port's `compact_obs_rows` against the JAX package's, bit for bit, in
f32 and bf16, with and without quirk_compat, on a stepped state (the cases
of tests/test_obs_compact.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_bots_tpu.config import NUM_ACTIONS
from madrona_bots_tpu.config import EnvConfig as JaxConfig
from madrona_bots_tpu.env.env import set_actions, step
from madrona_bots_tpu.env.state import init_state as jax_init_state
from madrona_bots_tpu.learn.obs import compact_obs_rows as jax_compact_obs_rows
from madrona_bots_tpu_torch.learn.obs import compact_obs_rows
from test_torch_state import jax_arrays


@pytest.fixture(scope="module")
def stepped():
    cfg = JaxConfig(num_worlds=4, init_agents=16, max_agents=32)
    state = jax_init_state(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)
    for _ in range(3):
        acts = np.zeros((cfg.num_worlds, cfg.max_agents, NUM_ACTIONS), np.int32)
        a = rng.integers(0, NUM_ACTIONS, (cfg.num_worlds, cfg.max_agents))
        acts[np.arange(cfg.num_worlds)[:, None], np.arange(cfg.max_agents)[None, :], a] = 1
        state = jax.jit(step, static_argnums=1)(set_actions(state, jnp.array(acts)), cfg)
    return cfg, jax_arrays(state)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("quirk", [False, True])
def test_compact_obs_rows_bit_equal(stepped, dtype, quirk):
    cfg, arr = stepped
    NS, rows = cfg.num_species, 6
    W, A = arr["alive"].shape
    Asub = A // NS
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    def cls(x, s):
        return x.reshape((W, Asub, NS) + x.shape[2:])[:, :, s]

    names = ("sensor_depth", "health", "pos", "sensor_semantic", "surrounding")
    for s in range(NS):
        m = cls(arr["alive"], s) & (cls(arr["species"], s) == s + 1)
        rank = np.cumsum(m, axis=1) - 1
        oh = (rank[:, None, :] == np.arange(rows)[None, :, None]) & (m & (rank < rows))[:, None, :]
        want = jax_compact_obs_rows(*(jnp.asarray(cls(arr[n], s)) for n in names),
                                    jnp.asarray(oh), quirk_compat=quirk, dtype=jd)
        got = compact_obs_rows(*(torch.from_numpy(cls(arr[n], s).copy()) for n in names),
                               torch.from_numpy(oh), quirk_compat=quirk, dtype=td)
        assert got.dtype == td and tuple(got.shape) == want.shape == (W * rows, cfg.obs_dim)
        np.testing.assert_array_equal(got.float().numpy().view(np.uint32),
                                      np.asarray(want, np.float32).view(np.uint32),
                                      err_msg=f"species {s}")
