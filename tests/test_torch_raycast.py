"""The port's plain raycast is bit-exact against the JAX `raycast`: the
geometry cases of tests/test_raycast.py and random states at densities
0.15-0.99. The kernel wrapper runs the plain version on CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_bots_tpu.config import EnvConfig as JaxConfig
from madrona_bots_tpu.env.raycast import ray_angle_offsets as jax_offsets
from madrona_bots_tpu.env.raycast import raycast as jax_raycast
from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.env.raycast import ray_angle_offsets, raycast
from madrona_bots_tpu_torch.ops import raycast_cuda


def both(kw, pos, heading, alive, species):
    want = jax_raycast(jnp.array(pos), jnp.array(heading), jnp.array(alive),
                       jnp.array(species), JaxConfig(**kw))
    got = raycast(torch.from_numpy(pos), torch.from_numpy(heading),
                  torch.from_numpy(alive), torch.from_numpy(species), EnvConfig(**kw))
    for name, w, g in zip(("depth", "semantic", "finder"), want, got):
        w = np.asarray(w)
        assert w.dtype == g.numpy().dtype, name
        np.testing.assert_array_equal(w, g.numpy(), err_msg=name)
    return [g.numpy() for g in got]


ONE = dict(num_worlds=1, init_agents=4, max_agents=4)


def test_offsets_match():
    np.testing.assert_array_equal(np.asarray(jax_offsets(JaxConfig())),
                                  ray_angle_offsets(EnvConfig()).numpy())


def test_sees_agent_dead_ahead():
    pos = np.array([[[20.0, 20.0], [30.0, 20.0], [0, 0], [0, 0]]], np.float32)
    depth, semantic, finder = both(ONE, pos, np.zeros((1, 4), np.float32),
                                   np.array([[True, True, False, False]]),
                                   np.array([[1, 2, 0, 0]], np.int32))
    assert finder[0, 0] == 1 and finder[0, 1] == -1
    nf = EnvConfig().num_forward_rays
    assert (semantic[0, 0, nf // 2 - 1: nf // 2 + 1] == 2).any()
    assert (semantic[0, 1, nf:] == 1).any()


def test_walls_everywhere_when_alone():
    pos = np.array([[[64.0, 48.0], [0, 0], [0, 0], [0, 0]]], np.float32)
    depth, semantic, finder = both(ONE, pos, np.array([[0.7, 0, 0, 0]], np.float32),
                                   np.array([[True, False, False, False]]),
                                   np.array([[3, 0, 0, 0]], np.int32))
    assert (semantic[0, 0] == 0).all() and (depth[0, 0] > 0).all()
    assert finder[0, 0] == -1


def test_near_clip_excludes_touching_agent():
    pos = np.array([[[20.0, 20.0], [21.5, 20.0], [0, 0], [0, 0]]], np.float32)
    _, semantic, finder = both(ONE, pos, np.zeros((1, 4), np.float32),
                               np.array([[True, True, False, False]]),
                               np.array([[1, 2, 0, 0]], np.int32))
    assert finder[0, 0] == -1 and (semantic[0, 0] != 2).all()


@pytest.mark.parametrize("density", [0.15, 0.4, 0.6, 0.99])
def test_random_states_match(density):
    r = np.random.default_rng(int(density * 100))
    W, A = 4, 32
    pos = (r.random((W, A, 2)) * np.array([127.0, 95.0])).astype(np.float32)
    heading = (r.random((W, A)) * 6.28).astype(np.float32)
    alive = r.random((W, A)) < density
    species = r.integers(1, 5, (W, A)).astype(np.int32)
    both(dict(num_worlds=W, init_agents=16, max_agents=A), pos, heading, alive, species)


def test_boundary_and_stacked_agents():
    """Agents on the walls, on the clamp limit and on top of one another."""
    W, A = 2, 16
    r = np.random.default_rng(5)
    pos = (r.random((W, A, 2)) * np.array([127.0, 95.0])).astype(np.float32)
    pos[0, :4] = [[0.0, 0.0], [127.0, 95.0], [0.0, 50.0], [60.0, 95.0]]
    pos[1, :6] = [30.0, 30.0]
    heading = (r.random((W, A)) * 12.0 - 6.0).astype(np.float32)
    heading[0, :4] = [0.0, np.pi, -np.pi / 2, np.pi / 2]
    both(dict(num_worlds=W, init_agents=8, max_agents=A), pos, heading,
         np.ones((W, A), bool), r.integers(1, 5, (W, A)).astype(np.int32))


def test_wrapper_takes_plain_version_on_cpu_and_checks_layout():
    cfg = EnvConfig(num_worlds=2, init_agents=8, max_agents=16)
    r = np.random.default_rng(0)
    pos = torch.from_numpy((r.random((2, 16, 2)) * 90).astype(np.float32))
    heading = torch.zeros((2, 16))
    alive = torch.ones((2, 16), dtype=torch.bool)
    species = torch.ones((2, 16), dtype=torch.int32)
    before = raycast_cuda.launches
    for a, b in zip(raycast_cuda.raycast(pos, heading, alive, species, cfg),
                    raycast(pos, heading, alive, species, cfg)):
        assert torch.equal(a, b)
    assert raycast_cuda.launches == before
    with pytest.raises(ValueError):
        raycast_cuda.raycast(pos, heading, alive, species.long(), cfg)
    with pytest.raises(ValueError):
        raycast_cuda.raycast(pos.transpose(0, 1).contiguous().transpose(0, 1),
                             heading, alive, species, cfg)
