"""The port's worlds-sharded scale-out (`parallel/`) in one process: the
draws' offsets, `init_state` for a range of worlds, `shard_state`, the env
step on shards, each rank's share of the PPO minibatches, and a gloo group
of one process in which the sharded A2C tick and PPO iteration equal the
unsharded ones in bits and the sharded tick matches the JAX package's on 8
virtual devices (tests/test_sharding.py's tolerance). Two processes:
tests/test_torch_multihost.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from madrona_bots_tpu import EnvConfig as JaxConfig
from madrona_bots_tpu import init_state as jax_init_state
from madrona_bots_tpu.learn import a2c as ja2c
from madrona_bots_tpu.models import ActorCritic as JaxAC
from madrona_bots_tpu.models import SpeciesNetGenerator as JaxGen
from madrona_bots_tpu.parallel import make_mesh as jax_make_mesh
from madrona_bots_tpu.parallel import make_sharded_train_tick as jax_sharded_tick
from madrona_bots_tpu.parallel import shard_state as jax_shard_state
from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.env import env as env_mod
from madrona_bots_tpu_torch.env.state import FIELDS, init_state, state_to_numpy
from madrona_bots_tpu_torch.learn import a2c, ppo
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator
from madrona_bots_tpu_torch.parallel import (Mesh, distributed, make_sharded_train_tick,
                                             shard_state, state_sharding)
from madrona_bots_tpu_torch.parallel.mesh import REPLICATED, SPLIT
from test_torch_a2c import jax_train_states_to_port
from test_torch_state import assert_arrays_equal, jax_arrays

CPU = "cpu"
KW = dict(num_worlds=8, init_agents=16, max_agents=32)


@pytest.mark.parametrize("fn", ["random_bits", "uniform", "gumbel"])
@pytest.mark.parametrize("rows", [(0, 3), (3, 7), (5, 10)])
def test_draw_offsets_slice_the_global_draw(fn, rows):
    key = rng.fold_in(rng.key(3), 11)
    n = 6
    full = getattr(rng, fn)(key, (10, n))
    part = getattr(rng, fn)(key, (rows[1] - rows[0], n), offset=rows[0] * n)
    assert torch.equal(part, full[rows[0]:rows[1]])


@pytest.mark.parametrize("stacked", [False, True])
def test_categorical_offset_slices_the_global_draw(stacked):
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((4, 12, 6) if stacked else (12, 6), generator=g)
    key = rng.key(5)
    keys = rng.fold_in(key, torch.arange(4)) if stacked else key
    full = rng.categorical(keys, logits)
    for lo, hi in ((0, 6), (6, 12), (3, 9)):
        part = rng.categorical(keys, logits[..., lo:hi, :], offset=lo * 6)
        assert torch.equal(part, full[..., lo:hi])


@pytest.mark.parametrize("worlds", [(0, 4), (4, 8), (2, 5), (7, 8)])
def test_init_state_for_a_world_range(worlds):
    lo, hi = worlds
    full = state_to_numpy(init_state(EnvConfig(**KW), 3, CPU))
    jax_full = jax_arrays(jax_init_state(jax.random.key(3), JaxConfig(**KW)))
    part = state_to_numpy(init_state(EnvConfig(**KW), 3, CPU, worlds=worlds))
    for want in (full, jax_full):
        assert_arrays_equal({f: want[f] if f == "step_count" else want[f][lo:hi]
                             for f in FIELDS}, part, str(worlds))
    with pytest.raises(ValueError):
        init_state(EnvConfig(**KW), 3, CPU, worlds=(4, 9))


def test_shard_state_and_state_sharding():
    spec = state_sharding(Mesh(0, 2, torch.device(CPU)))
    assert all(getattr(spec, f) == (REPLICATED if f == "step_count" else SPLIT) for f in FIELDS)
    full = init_state(EnvConfig(**KW), 0, CPU)
    shards = [shard_state(full, Mesh(r, 2, torch.device(CPU))) for r in range(2)]
    for r, sh in enumerate(shards):
        for f in FIELDS:
            x, y = getattr(full, f), getattr(sh, f)
            assert y.is_contiguous() and y.untyped_storage().data_ptr() != \
                x.untyped_storage().data_ptr(), f
            assert torch.equal(y, x if f == "step_count" else x[4 * r:4 * r + 4]), f
    shards[0].pos.add_(1.0)                           # a shard owns its tensors
    assert torch.equal(init_state(EnvConfig(**KW), 0, CPU).pos, full.pos)
    with pytest.raises(ValueError, match="do not split"):
        shard_state(full, Mesh(0, 3, torch.device(CPU)))


def test_env_step_on_halves_equals_full_step():
    """World independence: two shards stepped alone equal the full step in
    every field's bits (tests/test_sharding.py's first case)."""
    cfg = EnvConfig(num_worlds=16, init_agents=32, max_agents=64)
    full = init_state(cfg, 0, CPU)
    halves = [shard_state(full, Mesh(r, 2, torch.device(CPU))) for r in range(2)]
    g = np.random.default_rng(0)
    for _ in range(5):
        acts = torch.from_numpy(g.integers(0, 2, (16, 64, 6)).astype(np.int32))
        full = env_mod.step(env_mod.set_actions(full, acts), cfg)
        halves = [env_mod.step(env_mod.set_actions(h, acts[8 * r:8 * r + 8]), cfg)
                  for r, h in enumerate(halves)]
    want = state_to_numpy(full)
    got = [state_to_numpy(h) for h in halves]
    assert_arrays_equal(want, {f: got[0][f] if f == "step_count" else
                               np.concatenate([got[0][f], got[1][f]]) for f in FIELDS})


@dataclasses.dataclass(frozen=True)
class FakeMesh:
    """A rank's place without a process group: `shard_minibatches` reads
    only the world range."""
    rank: int
    size: int

    world_range = Mesh.world_range


@pytest.mark.parametrize("worlds,rows,T,M,decorrelate", [
    (8, 3, 2, 2, True), (8, 3, 3, 4, True), (8, 8, 2, 4, False), (12, 5, 2, 8, True)])
@pytest.mark.parametrize("ranks", [2, 4])
def test_shard_minibatches_partition_the_global_minibatches(worlds, rows, T, M, decorrelate,
                                                            ranks):
    """Over the ranks, each rank's rows of minibatch c are the global
    minibatch c's rows in its order, padded at the end; one rank's share
    is `minibatch_order` itself."""
    if (worlds % ranks) or (T * worlds * rows) % M:
        pytest.skip("shape does not split")
    cfg = EnvConfig(num_worlds=worlds, init_agents=8, max_agents=4 * 8)
    gen = SpeciesNetGenerator(cfg.obs_dim, 6, 8, cfg.hidden_state_dim, seed=0)
    models = [ActorCritic.from_generator(gen) for _ in range(4)]
    kw = dict(rollout_len=T, num_minibatches=M, learner_slots_per_class=rows,
              decorrelate=decorrelate)
    key = rng.key(17)
    B = T * worlds * rows
    glob = ppo.make_ppo_trainer(models, cfg, **kw)[0].minibatch_order(key, B, CPU).reshape(M, -1)
    one, present = ppo.make_ppo_trainer(models, cfg, mesh=FakeMesh(0, 1), **kw)[0] \
        .shard_minibatches(key, worlds, CPU)
    assert bool(present.all()) and torch.equal(one.reshape(M, -1), glob)
    Wl = worlds // ranks
    pos = [0] * M
    for r in range(ranks):
        tr = ppo.make_ppo_trainer(models, cfg, mesh=FakeMesh(r, ranks), **kw)[0]
        idx, present = tr.shard_minibatches(key, Wl, CPU)
        idx = idx.reshape(M, -1)
        assert idx.shape[1] == (T * Wl * rows // M if Wl * rows % M == 0
                                else T * -(-Wl * rows // M))
        t, q = idx // (Wl * rows), idx % (Wl * rows)
        g_idx = t * worlds * rows + r * Wl * rows + q          # local -> global row
        for c in range(M):
            n = int(present[c].sum())
            assert bool(present[c, :n].all()) and not bool(present[c, n:].any())
            mine = glob[c][(glob[c] // rows) % worlds // Wl == r]
            assert torch.equal(g_idx[c, :n], mine)
            pos[c] += n
    assert pos == [B // M] * M


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A gloo group of this one process (a file store, no TCP port)."""
    store = tmp_path_factory.mktemp("store") / "store"
    mesh = distributed.initialize(f"file://{store}", 1, 0, device=CPU, timeout_s=120)
    yield mesh
    distributed.shutdown()


def models_of(seed, hidden=16):
    cfg = EnvConfig(**KW)
    gen = SpeciesNetGenerator(cfg.obs_dim, 6, hidden, cfg.hidden_state_dim, seed=seed)
    return cfg, [ActorCritic.from_generator(gen) for _ in range(4)]


def leaves(ts):
    if isinstance(ts, tuple) and isinstance(ts[0], a2c.SpeciesTrainState):
        return [x for t in ts for x in leaves(t)]
    return [ts.params, *ts.opt_state]


def assert_runs_equal(one, other):
    (s1, ts1, m1), (s2, ts2, m2) = one, other
    for a, b in zip(leaves(ts1), leaves(ts2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert m1.keys() == m2.keys()
    for k in m1:
        assert m1[k].dtype == m2[k].dtype and torch.equal(m1[k], m2[k]), k
    assert_arrays_equal(state_to_numpy(s1), state_to_numpy(s2))


A2C_CASES = {"loop": dict(), "stacked": dict(learner_slots_per_class=6, stacked=True),
             "slots_quirks": dict(learner_slots_per_class=6, quirk_compat=True),
             "bf16_slots": dict(learner_slots_per_class=6, compute_dtype=torch.bfloat16)}


@pytest.mark.parametrize("name", list(A2C_CASES))
def test_sharded_tick_on_one_rank_is_the_tick(group, name):
    kw = A2C_CASES[name]
    cfg, models = models_of(4)
    init = a2c.init_stacked_train_state if kw.get("stacked") else a2c.init_train_states
    runs = []
    for sharded in (False, True):
        tick, opt = (make_sharded_train_tick(models, cfg, group, use_kernels=False, **kw)
                     if sharded else a2c.make_train_tick(models, cfg, use_kernels=False, **kw))
        ts = init(models, rng.key(1), opt)
        s = init_state(cfg, 0, CPU)
        s = shard_state(s, group) if sharded else s
        for t in range(2):
            s, ts, m = tick(s, ts, rng.fold_in(rng.key(9), t))
        runs.append((s, ts, m))
    assert_runs_equal(*runs)


PPO_CASES = {"loop": dict(), "slots": dict(learner_slots_per_class=3),
             "stacked": dict(learner_slots_per_class=3, stacked=True),
             "bf16_two_epochs": dict(learner_slots_per_class=3, compute_dtype=torch.bfloat16,
                                     update_epochs=2)}


@pytest.mark.parametrize("name", list(PPO_CASES))
def test_sharded_ppo_on_one_rank_is_the_iteration(group, name):
    kw = PPO_CASES[name]
    cfg, models = models_of(0)
    init = a2c.init_stacked_train_state if kw.get("stacked") else a2c.init_train_states
    runs = []
    for mesh in (None, group):
        it, opt = ppo.make_ppo_trainer(models, cfg, rollout_len=2, num_minibatches=2,
                                       use_kernels=False, mesh=mesh, **kw)
        ts = init(models, rng.key(1), opt)
        runs.append(it(init_state(cfg, 2, CPU, worlds=(0, 8)), ts, rng.key(3)))
    assert_runs_equal(*runs)


def test_sharded_tick_matches_jax_sharded_tick(group):
    """Two sharded ticks of the port against the JAX package's sharded tick
    on its 8-device mesh, with learner slots and quirks (the last case of
    tests/test_sharding.py): parameters and Adam state at its rtol 1e-3,
    atol 1e-4; alive, actions and dropped rows equal. (Each JAX compile
    takes ~20 s; the one-rank tests above hold the other paths to the
    unsharded tick, which tests/test_torch_a2c.py holds to JAX.)"""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    kw = dict(quirk_compat=True, learner_slots_per_class=6)
    jcfg, cfg = JaxConfig(**KW), EnvConfig(**KW)
    seed = 4
    jgen = JaxGen(jcfg.obs_dim, 6, 16, jcfg.hidden_state_dim, seed=seed)
    jmodels = [JaxAC.from_generator(jgen) for _ in range(4)]
    _, models = models_of(seed)
    jtick, jopt = jax_sharded_tick(jmodels, jcfg, jax_make_mesh(), **kw)
    tick, _ = make_sharded_train_tick(models, cfg, group, use_kernels=False, **kw)
    jts = ja2c.init_train_states(jmodels, jax.random.key(1), jopt)
    ts = jax_train_states_to_port(models, jts)
    js = jax_shard_state(jax_init_state(jax.random.key(0), jcfg), jax_make_mesh())
    s = shard_state(init_state(cfg, 0, CPU), group)
    for t in range(2):
        js, jts, jm = jtick(js, jts, jax.random.fold_in(jax.random.key(9), t))
        s, ts, m = tick(s, ts, rng.fold_in(rng.key(9), t))
    for a, b in zip(leaves(jax_train_states_to_port(models, jts)), leaves(ts)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-3, atol=1e-4)
    got, want = state_to_numpy(s), jax_arrays(js)
    for f in ("alive", "action"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for sp in range(1, 5):
        assert float(m[f"species_{sp}_dropped_rows"]) == float(jm[f"species_{sp}_dropped_rows"])
