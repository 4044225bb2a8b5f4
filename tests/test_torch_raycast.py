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
from madrona_bots_tpu_torch import trig
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
    both(*random_state(density))


def boundary_and_stacked_state():
    """Agents on the walls, on the clamp limit and on top of one another."""
    W, A = 2, 16
    r = np.random.default_rng(5)
    pos = (r.random((W, A, 2)) * np.array([127.0, 95.0])).astype(np.float32)
    pos[0, :4] = [[0.0, 0.0], [127.0, 95.0], [0.0, 50.0], [60.0, 95.0]]
    pos[1, :6] = [30.0, 30.0]
    heading = (r.random((W, A)) * 12.0 - 6.0).astype(np.float32)
    heading[0, :4] = [0.0, np.pi, -np.pi / 2, np.pi / 2]
    return (dict(num_worlds=W, init_agents=8, max_agents=A), pos, heading,
            np.ones((W, A), bool), r.integers(1, 5, (W, A)).astype(np.int32))


def test_boundary_and_stacked_agents():
    both(*boundary_and_stacked_state())


def random_state(density, W=4, A=32):
    r = np.random.default_rng(int(density * 100))
    pos = (r.random((W, A, 2)) * np.array([127.0, 95.0])).astype(np.float32)
    heading = (r.random((W, A)) * 6.28).astype(np.float32)
    alive = r.random((W, A)) < density
    species = r.integers(1, 5, (W, A)).astype(np.int32)
    return dict(num_worlds=W, init_agents=16, max_agents=A), pos, heading, alive, species


def tie_state(W=4, A=64):
    """Agents on a half-unit grid in a 12 x 12 patch, every fourth slot
    stacked on the slot before it, headings 0, pi/2 and pi: equal hit
    distances from stacked and mirror-image targets, so ties decide."""
    r = np.random.default_rng(9)
    pos = (20.0 + 0.5 * r.integers(0, 25, (W, A, 2))).astype(np.float32)
    pos[:, 3::4] = pos[:, 2::4]
    heading = r.choice(np.array([0.0, np.pi / 2, np.pi], np.float32), (W, A))
    alive = r.random((W, A)) < 0.85
    alive[:, 2::4] = alive[:, 3::4] = True
    species = r.integers(1, 5, (W, A)).astype(np.int32)
    return dict(num_worlds=W, init_agents=16, max_agents=A), pos, heading, alive, species


def kernel_model(kw, pos, heading, alive, species):
    """csrc/raycast.cu's fold order in numpy float32 (every product and sum
    rounded on its own): per world, the alive slots compacted ascending; per
    source a pair table (ocx, ocy, q, tag) with q = -3e38 at the source
    itself; per ray a strict-`<` fold over the targets ascending that takes
    the sqrt only when disc >= 0 and tc > near; the finder as 32 lane-strided
    partial minima reduced by (t, tag)."""
    cfg = EnvConfig(**kw)
    f32 = np.float32
    W, A = heading.shape
    S = cfg.sensor_size
    inf, near = f32(3.0e38), f32(cfg.near)
    r2 = f32(cfg.agent_radius * cfg.agent_radius)
    scale, lims = f32(255.0 / cfg.max_range), (f32(cfg.world_lim_x), f32(cfg.world_lim_y))
    offs = ray_angle_offsets(cfg).numpy()
    no_hit = np.iinfo(np.int32).max
    depth = np.zeros((W, A, S), np.uint8)
    semantic = np.full((W, A, S), -1, np.int8)
    finder = np.full((W, A), -1, np.int32)

    def fold(tmin, tag, e, dx, dy):
        ocx, ocy, q, etag = e
        tc = dx * ocx + dy * ocy
        disc = tc * tc + q
        go = (disc >= 0) & (tc > near)
        th = tc - np.sqrt(np.where(go, disc, f32(0)))
        take = go & (th > near) & (th < tmin)
        return np.where(take, th, tmin), np.where(take, etag, tag)

    def wall(p, d, lim):
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.fmin(np.where(d > 0, lim - p, -p) / d, inf)
        return np.where(d == 0, inf, t)

    for w in range(W):
        slots = np.nonzero(alive[w])[0]
        x, y = pos[w, slots, 0], pos[w, slots, 1]
        tags = (slots << 8) | (species[w, slots] & 0xFF)
        for j, slot in enumerate(slots):
            ocx, ocy = x - x[j], y - y[j]
            q = r2 - (ocx * ocx + ocy * ocy)
            q[j] = -inf
            table = list(zip(ocx, ocy, q, tags))
            dx, dy = (v.numpy() for v in trig.sincos(torch.from_numpy(heading[w, slot] + offs)))
            tmin, tag = np.full(S, inf, f32), np.full(S, no_hit)
            for e in table:
                tmin, tag = fold(tmin, tag, e, dx, dy)
            tw = np.fmin(wall(x[j], dx, lims[0]), wall(y[j], dy, lims[1]))
            tw = np.where(tw > near, tw, inf)
            t = np.fmin(tmin, tw)
            hit = t < inf
            db = 255 - np.fmin(np.floor(t * scale), f32(255)).astype(np.int32)
            depth[w, slot] = np.where(hit, db, 0)
            sem = np.where(tmin < tw, tag & 0xFF, 0).astype(np.uint8).view(np.int8)
            semantic[w, slot] = np.where(hit, sem, -1)

            fx, fy = (float(v) for v in trig.sincos(torch.from_numpy(heading[w, slot:slot + 1])))
            lanes = []
            for lane in range(32):
                lt, lg = inf, no_hit
                for e in table[lane::32]:
                    lt, lg = fold(lt, lg, e, f32(fx), f32(fy))
                lanes.append((f32(lt), int(lg)))
            best_t, best_tag = min(lanes)
            finder[w, slot] = best_tag >> 8 if best_t < inf else -1
    return depth, semantic, finder


@pytest.mark.parametrize("case", ["d0.15", "d0.6", "d0.99", "d1.0_A64", "d0.7_A64",
                                  "boundary_stacked", "ties_A64"])
def test_kernel_fold_order_model(case):
    """The kernel's fold order (pair table, cull before the sqrt, per-lane
    folds, the finder's (t, tag) reduction) gives the plain version's and
    the JAX raycast's bits: the CPU guard for the kernel's exactness."""
    if case == "boundary_stacked":
        args = boundary_and_stacked_state()
    elif case.startswith("ties"):
        args = tie_state()
    else:
        density, *rest = case[1:].split("_A")
        args = random_state(float(density), A=int(rest[0]) if rest else 32)
    want = both(*args)
    with np.errstate(over="ignore"):
        got = kernel_model(*args)
    for name, w, g in zip(("depth", "semantic", "finder"), want, got):
        np.testing.assert_array_equal(w, g, err_msg=name)
    if case.startswith("ties"):
        assert (want[2] >= 0).sum() > 20        # the finder hits, so ties decide


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
