"""The port's raycast (one design for every shape) against the JAX
package's packed and blocked Pallas raycast kernels, run in interpret mode:
the shapes at which the JAX dispatcher picks those kernels (W < 48; odd
capacities), bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_bots_tpu.config import EnvConfig as JaxConfig
from madrona_bots_tpu.ops.raycast_pallas import (raycast_pallas_blocked,
                                                 raycast_pallas_packed)
from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.ops import raycast_cuda


def random_world(seed, W, A, density, num_species=4):
    r = np.random.default_rng(seed)
    pos = (r.random((W, A, 2)) * np.array([127.0, 95.0])).astype(np.float32)
    heading = (r.random((W, A)) * 6.28).astype(np.float32)
    alive = r.random((W, A)) < density
    species = r.integers(1, num_species + 1, (W, A)).astype(np.int32)
    return pos, heading, alive, species


def assert_port_equals(want, args, cfg):
    got = raycast_cuda.raycast(*(torch.from_numpy(a) for a in args), cfg)
    for name, w, g in zip(("depth", "semantic", "finder"), want, got):
        w = np.asarray(w)
        assert w.dtype == g.numpy().dtype, name
        np.testing.assert_array_equal(w, g.numpy(), err_msg=name)


@pytest.mark.parametrize("quad", [False, True])
@pytest.mark.parametrize("density", [0.3, 0.45, 0.9])
def test_matches_packed_kernel(density, quad):
    """Pair tiles at W = 6 and quad tiles at W = 8, A = 32: density 0.3
    fits the packed quota, 0.9 falls back to the single sweep, 0.45 mixes."""
    W, A = (8, 32) if quad else (6, 32)
    kw = dict(num_worlds=W, init_agents=16, max_agents=A)
    args = random_world(int(density * 100) + quad, W, A, density)
    want = raycast_pallas_packed(*(jnp.asarray(a) for a in args), JaxConfig(**kw),
                                 interpret=True, quad=quad)
    assert_port_equals(want, args, EnvConfig(**kw))


@pytest.mark.parametrize("density", [1.0, 0.6])
def test_matches_blocked_kernel_odd_capacity(density):
    """W = 4, A = 33, 3 species: the blocked kernel's shape (odd A)."""
    W, A = 4, 33
    kw = dict(num_worlds=W, init_agents=33, max_agents=A, num_species=3)
    args = random_world(int(density * 10), W, A, density, num_species=3)
    want = raycast_pallas_blocked(*(jnp.asarray(a) for a in args), JaxConfig(**kw),
                                  interpret=True)
    assert_port_equals(want, args, EnvConfig(**kw))
