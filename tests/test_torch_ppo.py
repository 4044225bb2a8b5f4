"""The port's PPO iteration against the jitted JAX `make_ppo_trainer`.

Each case runs one iteration from the same state (`init_state`), train
states (`init_train_states(models, key(1))`) and key in both packages at 4
worlds x 32 slots, hidden 32, rollout 3, 2 minibatches. Compared: every
world-state field bit-exact but `surrounding` (SPEC D10) and `hidden`
(XLA:CPU's tanh approximation; in bf16 also where each package rounds),
parameters, Adam state and metrics within the stated tolerances,
`dropped_rows` exactly. Also the PPO optimizer against optax, GAE against a
jitted `lax.scan` of the JAX body, the rollout checksum of the JAX
package's `MBOTS_PPO_STAGE=rollout` mode, and the bf16 record pack against
the Pallas row gather in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from madrona_bots_tpu import EnvConfig as JaxConfig
from madrona_bots_tpu import init_state as jax_init_state
from madrona_bots_tpu.learn import a2c as ja2c
from madrona_bots_tpu.learn import ppo as jppo
from madrona_bots_tpu.learn.pack import compact_slots as jax_compact_slots
from madrona_bots_tpu.learn.pack import split3 as jax_split3
from madrona_bots_tpu.models import ActorCritic as JaxAC
from madrona_bots_tpu.models import SpeciesNetGenerator as JaxGen
from madrona_bots_tpu.ops.row_gather import compact_fields as jax_compact_fields
from madrona_bots_tpu.ops.row_gather import kslot_from_class_slots as jax_kslot
from madrona_bots_tpu_torch import init_state, rng
from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.env import env as env_mod
from madrona_bots_tpu_torch.env.state import FIELDS, state_from_numpy, state_to_numpy
from madrona_bots_tpu_torch.learn import ppo
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator
from madrona_bots_tpu_torch.ops import row_gather_cuda
from test_torch_a2c import jax_train_states_to_port
from test_torch_state import jax_arrays

KW = dict(num_worlds=4, init_agents=16, max_agents=32)
HIDDEN = 32
LR = 3e-4
GAMMA, LAMBDA = 0.99, 0.95
CASES = {
    # name: (make_ppo_trainer kwargs, generator seed, MBOTS_PACK_KERNEL)
    "f32": (dict(), 0, None),
    "f32_slots": (dict(learner_slots_per_class=3), 1, None),
    "bf16_slots": (dict(learner_slots_per_class=3, compute_dtype="bf16"), 2, None),
    "bf16_slots_pack_kernel": (dict(learner_slots_per_class=3, compute_dtype="bf16"), 3, "1"),
    "f32_fixed_order_2_epochs": (dict(decorrelate=False, update_epochs=2), 4, None),
    # Epoch e visits minibatch (i + e) % M after the key-derived roll.
    "f32_decorrelated_2_epochs": (dict(decorrelate=True, update_epochs=2), 5, None),
}
# Tolerances. f32: parameters within 1e-6 where the JAX first moment is at
# least 1e-7 (a well-conditioned Adam step) and within 2 lr everywhere (a
# gradient behind a tanh that saturates to exactly 1 in XLA:CPU but not in
# torch turns into up to lr a step; see tests/test_torch_a2c.py). bf16:
# XLA:CPU keeps f32 between ops of a bf16 graph (excess precision), torch
# rounds after every op; where a weight gradient is a sum that cancels (the
# feature layers, whose inputs hold positions and health of ~100), torch's
# bf16 gradient differs from its own f32 one by up to ~7% in direction. So a
# bf16 update is held by its direction (cosine >= 0.9 against the JAX
# update of the same species), within 2 lr per Adam step everywhere, with a
# mean difference under lr / 10 per step, and its Adam moments by direction
# too (cosine >= 0.9). f32 moments are held within rtol plus moment_atol of
# the largest |moment|.
TOL = {"f32": dict(rtol=1e-4, atol=1e-5, mem_atol=1e-5, moment_atol=1e-4),
       "bf16": dict(rtol=1e-2, atol=1e-3, mem_atol=2e-2)}


def trainers(name, monkeypatch=None):
    """(JAX models, port models, JAX trainer and optimizer, port trainer) for
    a case; the JAX trainer reads MBOTS_PACK_KERNEL when it is built."""
    kwargs, seed, pack_kernel = CASES[name]
    kwargs = dict(kwargs, rollout_len=3, num_minibatches=2)
    bf = kwargs.pop("compute_dtype", None) == "bf16"
    jcfg, tcfg = JaxConfig(**KW), EnvConfig(**KW)
    jgen = JaxGen(jcfg.obs_dim, 6, HIDDEN, jcfg.hidden_state_dim, seed=seed)
    tgen = SpeciesNetGenerator(tcfg.obs_dim, 6, HIDDEN, tcfg.hidden_state_dim, seed=seed)
    jmodels = [JaxAC.from_generator(jgen) for _ in range(4)]
    tmodels = [ActorCritic.from_generator(tgen) for _ in range(4)]
    if pack_kernel is not None and monkeypatch is not None:
        monkeypatch.setenv("MBOTS_PACK_KERNEL", pack_kernel)
    jit, jopt = jppo.make_ppo_trainer(jmodels, jcfg, compute_dtype=jnp.bfloat16 if bf else None,
                                      **kwargs)
    tit, _ = ppo.make_ppo_trainer(tmodels, tcfg, compute_dtype=torch.bfloat16 if bf else None,
                                  **kwargs)
    return jmodels, tmodels, jit, jopt, tit, seed, bf, kwargs


def run_case(name, monkeypatch):
    """One iteration in each package from the same inputs: (JAX state, JAX
    train states as port tensors, JAX metrics, port state, port train
    states, port metrics, bf16?, Adam steps, parameters before)."""
    jmodels, tmodels, jit, jopt, tit, seed, bf, kwargs = trainers(name, monkeypatch)
    jts = ja2c.init_train_states(jmodels, jax.random.key(1), jopt)
    tts = jax_train_states_to_port(tmodels, jts)
    before = [t.params.clone() for t in tts]
    js = jax_init_state(jax.random.key(seed), JaxConfig(**KW))
    ts = state_from_numpy(jax_arrays(js), device="cpu")
    key = 30 + seed
    js, jts, jm = jit(js, jts, jax.random.key(key))
    ts, tts, tm = tit(ts, tts, rng.key(key))
    steps = 2 * kwargs.get("update_epochs", 1)
    return (jax_arrays(js), jax_train_states_to_port(tmodels, jts),
            {k: float(v) for k, v in jm.items()}, state_to_numpy(ts), tts,
            {k: float(v) for k, v in tm.items()}, bf, steps, before)


@pytest.fixture(scope="module")
def results():
    return {}


def get(results, name, monkeypatch):
    if name not in results:
        results[name] = run_case(name, monkeypatch)
    return results[name]


@pytest.mark.parametrize("name", list(CASES))
def test_state_exact(results, monkeypatch, name):
    want, _, _, got, _, _, _, _, _ = get(results, name, monkeypatch)
    for f in FIELDS:
        if f in ("surrounding", "hidden"):
            continue
        assert int((want[f] != got[f]).sum()) == 0, (name, f)
    np.testing.assert_allclose(got["surrounding"], want["surrounding"], rtol=1e-5, atol=1e-4)
    assert int(got["action"].sum()) > 0 and int(want["step_count"]) == 3


@pytest.mark.parametrize("name", list(CASES))
def test_hidden_close(results, monkeypatch, name):
    want, _, _, got, _, _, bf, _, _ = get(results, name, monkeypatch)
    tol = TOL["bf16" if bf else "f32"]
    np.testing.assert_allclose(got["hidden"], want["hidden"], rtol=tol["rtol"],
                               atol=tol["mem_atol"])
    # The same rows hold memory (alive rows of the last step's forwards).
    assert np.array_equal((got["hidden"] != 0).any(-1), (want["hidden"] != 0).any(-1))


@pytest.mark.parametrize("name", list(CASES))
def test_params_and_moments_close(results, monkeypatch, name):
    _, jts, _, _, tts, _, bf, steps, before = get(results, name, monkeypatch)
    tol = TOL["bf16" if bf else "f32"]
    for j, t, p0 in zip(jts, tts, before):
        diff = (t.params - j.params).abs()
        moved = float((t.params - p0).abs().max())
        if bf:
            dj, dt = j.params - p0, t.params - p0
            assert float((dj * dt).sum() / (dj.norm() * dt.norm())) >= 0.9, name
            assert moved >= LR, name
            assert float(diff.max()) <= 2 * LR * steps, name
            assert float(diff.mean()) < LR / 10 * steps, name
        else:
            assert moved > 100 * float(diff.max()), name
            assert float(diff.max()) <= 2 * LR, name
            sure = j.opt_state.mu.abs() >= 1e-7
            assert int(sure.sum()) >= 1000
            assert float(diff[sure].max()) <= 1e-6, name
        assert int(t.opt_state.count) == int(j.opt_state.count) == steps
        for a, b in ((t.opt_state.mu, j.opt_state.mu), (t.opt_state.nu, j.opt_state.nu)):
            if bf:
                assert float((a * b).sum() / (a.norm() * b.norm())) >= 0.9, name
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol["rtol"],
                                           atol=tol["moment_atol"] * float(b.abs().max()))


@pytest.mark.parametrize("name", list(CASES))
def test_metrics_close(results, monkeypatch, name):
    _, _, jm, _, _, tm, bf, _, _ = get(results, name, monkeypatch)
    tol = TOL["bf16" if bf else "f32"]
    assert list(tm) == [f"species_{s}_{k}" for s in range(1, 5)
                        for k in ppo.PER_SPECIES_METRICS] + ["env_steps"]
    assert sorted(tm) == sorted(jm)
    for k, v in jm.items():
        assert np.isfinite(tm[k]), k
        if k.endswith(("_dropped_rows", "_count", "env_steps")):
            assert tm[k] == v, k
        else:
            assert tm[k] == pytest.approx(v, rel=tol["rtol"], abs=tol["atol"]), k


def test_slot_cases_drop_rows(results, monkeypatch):
    for name in ("f32_slots", "bf16_slots", "bf16_slots_pack_kernel"):
        _, _, _, _, _, tm, _, _, _ = get(results, name, monkeypatch)
        assert sum(tm[f"species_{s}_dropped_rows"] for s in range(1, 5)) > 0, name


@pytest.mark.parametrize("norm", [0.05, 50.0])
def test_ppo_optimizer_matches_optax(norm):
    """Gradients with a global norm above (clipped) and below the limit."""
    r = np.random.default_rng(int(norm * 100))
    p = r.normal(size=500).astype(np.float32)
    opt = jppo.make_ppo_optimizer(3e-4, 0.5)
    jp, js = jnp.asarray(p), opt.init(jnp.asarray(p))
    topt = ppo.make_ppo_optimizer(3e-4, 0.5)
    tp = torch.from_numpy(p)
    tstate = topt.init(tp)
    update = jax.jit(opt.update)
    for _ in range(4):
        g = r.normal(size=500).astype(np.float32)
        g *= np.float32(norm / np.linalg.norm(g))
        upd, js = update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, tstate = topt.update(torch.from_numpy(g), tstate, tp)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    count, mu, nu = jax.tree.leaves(js)
    assert int(tstate.count) == int(count) == 4
    np.testing.assert_allclose(tstate.mu.numpy(), np.asarray(mu), rtol=1e-6,
                               atol=1e-6 * float(np.abs(mu).max()))
    np.testing.assert_allclose(tstate.nu.numpy(), np.asarray(nu), rtol=1e-6,
                               atol=1e-6 * float(np.abs(nu).max()))


def test_gae_bit_exact():
    """Deaths mid-rollout, births, rewards over five decades."""
    def body(carry, x):                        # madrona_bots_tpu/learn/ppo.py:447-454
        r, al, nal, v = x
        g, next_value = carry
        alive_next = nal & al
        nv = jnp.where(alive_next, next_value, 0.0)
        delta = r + GAMMA * nv - v
        g = delta + GAMMA * LAMBDA * jnp.where(alive_next, g, 0.0)
        return (g, v), g

    @jax.jit
    def jgae(r, al, nal, v, last):
        return jax.lax.scan(body, (jnp.zeros_like(last), last), (r, al, nal, v),
                            reverse=True)[1]

    g = np.random.default_rng(0)
    T, W, A = 16, 32, 64
    r = (g.normal(size=(T, W, A)) * g.choice([1e-3, 1.0, 100.0], size=(T, W, A))).astype(np.float32)
    v = (g.normal(size=(T, W, A)) * 10).astype(np.float32)
    last = (g.normal(size=(W, A)) * 10).astype(np.float32)
    al = g.random((T, W, A)) < 0.8
    nal = (g.random((T, W, A)) < 0.9) & al
    nal[:-1] |= al[1:] & (g.random((T - 1, W, A)) < 0.1)     # births
    assert (al & ~nal).any() and (~al[1:] & nal[:-1]).any()
    want = np.asarray(jgae(r, al, nal, v, last))
    got = ppo.gae(*(torch.from_numpy(x) for x in (r, al, nal, v, last)), GAMMA, LAMBDA)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_rollout_checksum_matches_jax_stage(monkeypatch):
    """The JAX package's MBOTS_PPO_STAGE=rollout checksum (the advantages'
    sum plus every rollout record's sum) against the same sum of the port's
    rollout, bf16 with learner slots."""
    monkeypatch.setenv("MBOTS_PPO_STAGE", "rollout")
    jmodels, tmodels, jit, jopt, tit, seed, _, _ = trainers("bf16_slots", monkeypatch)
    monkeypatch.delenv("MBOTS_PPO_STAGE")
    jts = ja2c.init_train_states(jmodels, jax.random.key(1), jopt)
    tts = jax_train_states_to_port(tmodels, jts)
    js = jax_init_state(jax.random.key(seed), JaxConfig(**KW))
    ts = state_from_numpy(jax_arrays(js), device="cpu")
    _, _, jm = jit(js, jts, jax.random.key(5))
    params = [t.params for t in tts]
    ts, key, roll = tit.rollout(ts, params, rng.key(5))
    adv = tit.advantages(ts, params, key, roll)
    assert isinstance(roll, ppo.RolloutC)
    got = float(adv.sum()) + sum(float(x.to(torch.float32).sum()) for x in roll)
    assert got == pytest.approx(float(jm["stage_checksum"]), rel=1e-6)


def stepped(cfg, seed, steps=3):
    g = np.random.default_rng(seed)
    state = init_state(cfg, seed, device="cpu")
    W, A = cfg.num_worlds, cfg.max_agents
    for _ in range(steps):
        a = np.zeros((W, A, 6), np.int32)
        a[np.arange(W)[:, None], np.arange(A)[None, :], g.integers(0, 6, (W, A))] = 1
        a[:, :, 5] |= g.integers(0, 2, (W, A)).astype(np.int32)
        state = env_mod.step(env_mod.set_actions(state, torch.from_numpy(a)), cfg)
    return state


@pytest.mark.parametrize("rows", [3, 8])
def test_bf16_record_pack_matches_pallas_pack(rows):
    """`pack_records` in bf16 against the JAX package's MBOTS_PACK_KERNEL
    pack (madrona_bots_tpu/learn/ppo.py:349-386) with the Pallas row
    gather in interpret mode: rec, valid, srcrow and dropped, bit for bit."""
    cfg = EnvConfig(num_worlds=6, init_agents=40, max_agents=64)
    state = stepped(cfg, 3)
    W, A, NS, H = 6, 64, 4, cfg.hidden_state_dim
    g = np.random.default_rng(rows)
    state.hidden.copy_(torch.from_numpy(g.normal(size=(W, A, H)).astype(np.float32)))
    action = torch.from_numpy(g.integers(0, 6, (W, A)))
    logp = torch.from_numpy(-g.exponential(size=(W, A)).astype(np.float32))
    value = torch.from_numpy((g.normal(size=(W, A)) * 30).astype(np.float32))
    models = [ActorCritic.from_generator(SpeciesNetGenerator(cfg.obs_dim, 6, 16, H, seed=0))
              for _ in range(NS)]
    trainer, _ = ppo.make_ppo_trainer(models, cfg, rollout_len=2, num_minibatches=2,
                                      compute_dtype=torch.bfloat16,
                                      learner_slots_per_class=rows)
    obs = ppo._flat_obs(state.sensor_depth, state.health, state.pos, state.sensor_semantic,
                        state.surrounding, torch.bfloat16)
    rec, valid, srcrow, dropped = trainer.pack_records(state, obs, action, logp, value)

    s = jax_arrays_of(state)
    Asub, G = A // NS, NS * W
    spec = jnp.arange(1, NS + 1, dtype=jnp.int32)

    def cm(x):
        x4 = x.reshape((W, Asub, NS) + x.shape[2:])
        return x4.transpose((2, 0, 1) + tuple(range(3, x4.ndim))).reshape((G, Asub) + x.shape[2:])

    m = cm(s["alive"] & (s["species"] == jnp.tile(spec, Asub)[None, :]))
    slot, jvalid, keep = jax_compact_slots(m, rows)
    jobs = jppo._flat_obs(s["sensor_depth"], s["health"], s["pos"], s["sensor_semantic"],
                          s["surrounding"], jnp.bfloat16)
    scal = jnp.concatenate([jnp.asarray(action.numpy())[..., None].astype(jnp.bfloat16)]
                           + [p[..., None] for p in jax_split3(jnp.asarray(logp.numpy()))]
                           + [p[..., None] for p in jax_split3(jnp.asarray(value.numpy()))], -1)
    co, cmem, cs = jax_compact_fields(jax_kslot(slot, jvalid, W, NS),
                                      [jobs, s["hidden"].astype(jnp.bfloat16), scal],
                                      interpret=True)
    jrec = (jnp.concatenate([co, cmem, cs], -1).reshape(W, NS, rows, -1)
            .transpose(1, 0, 2, 3).reshape(G * rows, -1))
    jsrc = slot * NS + (jnp.arange(G, dtype=jnp.int32) // W)[:, None]
    jdrop = m.reshape(NS, W, Asub).sum((1, 2)) - keep.reshape(NS, W, Asub).sum((1, 2))
    assert np.array_equal(rec.view(torch.int16).numpy(),
                          np.asarray(jrec).view(np.int16))
    assert np.array_equal(valid.numpy(), np.asarray(jvalid).reshape(-1))
    assert np.array_equal(srcrow.numpy(), np.asarray(jsrc).reshape(-1))
    assert np.array_equal(dropped.numpy(), np.asarray(jdrop))
    assert int(valid.sum()) > 0 and (rows == 8 or int(dropped.sum()) > 0)


def jax_arrays_of(state):
    return {k: jnp.asarray(v) for k, v in state_to_numpy(state).items()}


def test_cpu_iteration_launches_no_kernel_and_refuses_stacked():
    """On CPU tensors the bf16 record pack runs the gather's plain version
    through the kernel wrapper, which counts no launch, in the loop and the
    stacked trainer; the stacked trainer without learner slots and a batch
    that does not split into minibatches are refused."""
    cfg = EnvConfig(num_worlds=2, init_agents=16, max_agents=32)
    models = [ActorCritic.from_generator(SpeciesNetGenerator(cfg.obs_dim, 6, 16,
                                                             cfg.hidden_state_dim, seed=0))
              for _ in range(4)]
    it, opt = ppo.make_ppo_trainer(models, cfg, rollout_len=2, num_minibatches=2,
                                   compute_dtype=torch.bfloat16, learner_slots_per_class=3)
    sit, sopt = ppo.make_ppo_trainer(models, cfg, rollout_len=2, num_minibatches=2,
                                     compute_dtype=torch.bfloat16, learner_slots_per_class=3,
                                     stacked=True)
    from madrona_bots_tpu_torch.learn.a2c import init_stacked_train_state, init_train_states
    tstates = init_train_states(models, rng.key(0), opt)
    sts = init_stacked_train_state(models, rng.key(0), sopt)
    before = row_gather_cuda.launches
    state, tstates, m = it(init_state(cfg, 0, device="cpu"), tstates, rng.key(1))
    state, sts, sm = sit(state, sts, rng.key(2))
    assert row_gather_cuda.launches == before
    assert all(np.isfinite(float(v)) for v in m.values())
    assert list(sm) == list(m) and all(np.isfinite(float(v)) for v in sm.values())
    assert all(t.params.dtype == torch.float32 for t in tstates)
    assert int(state.step_count) == 4 and int(sts.opt_state.count) == 2
    with pytest.raises(ValueError, match="compaction"):
        ppo.make_ppo_trainer(models, cfg, stacked=True)
    with pytest.raises(ValueError, match="minibatches"):
        ppo.make_ppo_trainer(models, cfg, rollout_len=3, num_minibatches=5)
