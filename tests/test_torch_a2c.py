"""The port's A2C train tick against the jitted JAX `make_train_tick`.

Each case runs one JAX tick from init to get a warm state (count-1 Adam
state, written-back memory, valid prev buffers), then one tick from that
same state, parameters and key in both packages. Compared: every env field
bit-exact, the sampled actions equal, memory, parameters, Adam moments and
metrics within the stated tolerances. Also Adam alone against optax and
the learner-row plumbing of the bf16 compacting tick.
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
from madrona_bots_tpu.models import ActorCritic as JaxAC
from madrona_bots_tpu.models import SpeciesNetGenerator as JaxGen
from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.env.state import FIELDS, state_from_numpy, state_to_numpy
from madrona_bots_tpu_torch.learn import a2c
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator
from madrona_bots_tpu_torch.ops import row_gather_cuda
from test_torch_state import jax_arrays

KW = dict(num_worlds=4, init_agents=32, max_agents=64)
HIDDEN = 32
# Fields holding learner floats; every other field must be bit-exact.
FLOAT_FIELDS = ("hidden", "prev_hidden", "surrounding", "prev_surrounding")

CASES = {
    # name: (make_train_tick kwargs, generator seed)
    "f32": (dict(), 0),
    "f32_slots": (dict(learner_slots_per_class=5), 1),
    "bf16_slots_kernel": (dict(learner_slots_per_class=5, compute_dtype="bf16"), 2),
    "quirks": (dict(quirk_compat=True, proper_log_probs=True, quirk_inloop_shift=True), 3),
}
LR = 3e-4
# Parameters: Adam's step is -lr * m_hat / (sqrt(v_hat) + 1e-8), so where a
# gradient is within ~1e-8 of zero the step is ill-conditioned. XLA:CPU's
# tanh is an approximation that reaches exactly +-1 from |x| ~ 8.0, torch's
# (correctly rounded) only from 9.01, so gradients behind a saturated tanh
# are exactly 0 in JAX and ~1e-9 in torch, and their first step differs by
# up to lr. f32 parameters are held within 1e-6 after one update from init
# (1e-5 after a second, whose gradients start from the first update's
# differences) wherever the JAX first moment is at least 1e-7 (a
# well-conditioned step), and within 2 lr everywhere. bf16 forwards round at other places in XLA (f32 inside a
# fusion) and torch (after every op), which flips the sign of small bf16
# gradients: bf16 parameters are held within 2 lr everywhere, with a mean
# difference under lr / 20.
# Moments are held within rtol plus moment_atol of the largest |moment|.
TOL = {"f32": dict(rtol=1e-4, mem_atol=1e-5, moment_atol=1e-4),
       "bf16": dict(rtol=1e-2, mem_atol=2e-2, moment_atol=5e-2)}


def jax_train_states_to_port(models, tstates):
    out = []
    for m, ts in zip(models, tstates):
        params = m.flatten([torch.from_numpy(np.array(x))
                            for x in jax.tree.leaves(ts.params)])
        count, mu, nu = (torch.from_numpy(np.array(x)) for x in jax.tree.leaves(ts.opt_state))
        out.append(a2c.SpeciesTrainState(params, a2c.AdamState(count, mu, nu)))
    return tuple(out)


def run_case(name):
    """Two ticks: from init (fresh train states), then from the JAX
    package's warm state. Each from the same inputs in both packages.
    Returns [(jax state, jax train states, jax metrics, port state, port
    train states, port metrics)] per tick, and whether the case is bf16."""
    kwargs, seed = CASES[name]
    kwargs = dict(kwargs)
    bf = kwargs.pop("compute_dtype", None) == "bf16"
    jcfg, tcfg = JaxConfig(**KW), EnvConfig(**KW)
    jgen = JaxGen(jcfg.obs_dim, 6, HIDDEN, jcfg.hidden_state_dim, seed=seed)
    tgen = SpeciesNetGenerator(tcfg.obs_dim, 6, HIDDEN, tcfg.hidden_state_dim, seed=seed)
    jmodels = [JaxAC.from_generator(jgen) for _ in range(4)]
    tmodels = [ActorCritic.from_generator(tgen) for _ in range(4)]
    jtick, jopt = ja2c.make_train_tick(jmodels, jcfg, compute_dtype=jnp.bfloat16 if bf else None,
                                       **kwargs)
    ttick, topt = a2c.make_train_tick(tmodels, tcfg, compute_dtype=torch.bfloat16 if bf else None,
                                      **kwargs)
    jts = ja2c.init_train_states(jmodels, jax.random.key(1), jopt)
    tts = a2c.init_train_states(tmodels, rng.key(1), topt)
    for j, t in zip(jax_train_states_to_port(tmodels, jts), tts):   # init: bit-equal
        assert torch.equal(j.params, t.params)
    js = jax_init_state(jax.random.key(seed), jcfg)
    ticks = []
    for key in (10 + seed, 20 + seed):
        ts = state_from_numpy(jax_arrays(js), device="cpu")
        tts = jax_train_states_to_port(tmodels, jts)
        js, jts, jm = jtick(js, jts, jax.random.key(key))
        ts, tts, tm = ttick(ts, tts, rng.key(key))
        ticks.append((jax_arrays(js), jax_train_states_to_port(tmodels, jts),
                      {k: float(v) for k, v in jm.items()}, state_to_numpy(ts), tts,
                      {k: float(v) for k, v in tm.items()}))
    return ticks, bf


@pytest.fixture(scope="module")
def results():
    return {}


def get(results, name, monkeypatch):
    if name not in results:
        if name == "bf16_slots_kernel":
            monkeypatch.setenv("MBOTS_PACK_KERNEL", "1")
        results[name] = run_case(name)
    return results[name]


@pytest.mark.parametrize("name", list(CASES))
def test_env_fields_and_actions_exact(results, monkeypatch, name):
    ticks, _ = get(results, name, monkeypatch)
    for t, (want, _, _, got, _, _) in enumerate(ticks):
        for f in FIELDS:
            if f in FLOAT_FIELDS:
                continue
            bad = int((want[f] != got[f]).sum())
            assert bad == 0, (name, t, f, bad)
        assert (got["action"].sum(-1)[got["alive"]] <= 1).all()
        assert int(got["action"].sum()) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_memory_and_surrounding_close(results, monkeypatch, name):
    ticks, bf = get(results, name, monkeypatch)
    tol = TOL["bf16" if bf else "f32"]
    for want, _, _, got, _, _ in ticks:
        for f in ("hidden", "prev_hidden"):
            np.testing.assert_allclose(got[f], want[f], rtol=tol["rtol"],
                                       atol=tol["mem_atol"], err_msg=f)
            # Rows written back (alive learner rows) are the same in both.
            assert np.array_equal((got[f] != 0).any(-1), (want[f] != 0).any(-1)), f
        for f in ("surrounding", "prev_surrounding"):
            np.testing.assert_allclose(got[f], want[f], rtol=1e-5, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("name", list(CASES))
def test_params_and_moments_close(results, monkeypatch, name):
    ticks, bf = get(results, name, monkeypatch)
    tol = TOL["bf16" if bf else "f32"]
    for step, (_, jts, _, _, tts, _) in enumerate(ticks, start=1):
        for j, t in zip(jts, tts):
            diff = (t.params - j.params).abs()
            assert float(diff.max()) <= 2 * LR, (name, step)
            if bf:
                assert float(diff.mean()) < LR / 20, (name, step)
            else:
                sure = j.opt_state.mu.abs() >= 1e-7
                assert float(diff[sure].max()) <= (1e-6 if step == 1 else 1e-5), (name, step)
                assert int(sure.sum()) >= 1000
            assert int(t.opt_state.count) == int(j.opt_state.count) == step
            for a, b in ((t.opt_state.mu, j.opt_state.mu), (t.opt_state.nu, j.opt_state.nu)):
                scale = float(b.abs().max())
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol["rtol"],
                                           atol=tol["moment_atol"] * scale)


@pytest.mark.parametrize("name", list(CASES))
def test_metrics_close(results, monkeypatch, name):
    ticks, bf = get(results, name, monkeypatch)
    tol = TOL["bf16" if bf else "f32"]
    for _, _, jm, _, _, tm in ticks:
        assert sorted(tm) == sorted(jm)
        for k, v in jm.items():
            if k.endswith(("_count", "_dropped_rows", "_count_per_world", "_reward",
                           "_avg_health", "_popular_action")):
                assert tm[k] == pytest.approx(v, rel=1e-6, abs=1e-6), k
            else:
                assert tm[k] == pytest.approx(v, rel=tol["rtol"], abs=tol["rtol"]), k


def test_slots_cases_drop_rows(results, monkeypatch):
    for name in ("f32_slots", "bf16_slots_kernel"):
        ticks, _ = get(results, name, monkeypatch)
        tm = ticks[0][5]
        assert sum(tm[f"species_{s}_dropped_rows"] for s in range(1, 5)) > 0, name


def test_adam_matches_optax():
    r = np.random.default_rng(0)
    p = r.normal(size=300).astype(np.float32)
    opt = optax.flatten(optax.adam(3e-4, b1=0.9, b2=0.999, eps=1e-8))
    jp, js = jnp.asarray(p), opt.init(jnp.asarray(p))
    adam = a2c.make_optimizer(3e-4)
    tp = torch.from_numpy(p)
    tstate = adam.init(tp)
    for t in range(5):
        g = (r.normal(size=300) * 10.0 ** r.integers(-9, 1, 300)).astype(np.float32)
        upd, js = jax.jit(opt.update)(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, tstate = adam.update(torch.from_numpy(g), tstate, tp)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-7)
    count, mu, nu = jax.tree.leaves(js)
    assert int(tstate.count) == int(count) == 5
    np.testing.assert_allclose(tstate.mu.numpy(), np.asarray(mu), rtol=1e-6,
                               atol=1e-6 * float(np.abs(mu).max()))
    np.testing.assert_allclose(tstate.nu.numpy(), np.asarray(nu), rtol=1e-6,
                               atol=1e-6 * float(np.abs(nu).max()))


def test_bf16_tick_launches_gather_only_through_wrapper():
    """On CPU tensors the bf16 compacting tick runs the gather's plain
    version through the kernel wrapper, which counts no launch."""
    cfg = EnvConfig(num_worlds=2, init_agents=16, max_agents=32)
    gen = SpeciesNetGenerator(cfg.obs_dim, 6, 16, cfg.hidden_state_dim, seed=0)
    models = [ActorCritic.from_generator(gen) for _ in range(4)]
    tick, opt = a2c.make_train_tick(models, cfg, compute_dtype=torch.bfloat16,
                                    learner_slots_per_class=3)
    from madrona_bots_tpu_torch import init_state
    state = init_state(cfg, 0, device="cpu")
    tstates = a2c.init_train_states(models, rng.key(0), opt)
    stick, _ = a2c.make_train_tick(models, cfg, compute_dtype=torch.bfloat16,
                                   learner_slots_per_class=3, stacked=True)
    sts = a2c.init_stacked_train_state(models, rng.key(0), opt)
    before = row_gather_cuda.launches
    state, tstates, m = tick(state, tstates, rng.key(1))
    state, sts, sm = stick(state, sts, rng.key(2))
    assert row_gather_cuda.launches == before
    assert all(np.isfinite(float(v)) for v in m.values())
    assert list(sm) == list(m)
    assert all(np.isfinite(float(v)) for v in sm.values())
    assert all(t.params.dtype == torch.float32 for t in tstates)
    assert sts.params.dtype == torch.float32
    # The stacked tick needs learner-slot compaction.
    with pytest.raises(ValueError, match="compaction"):
        a2c.make_train_tick(models, cfg, stacked=True)
