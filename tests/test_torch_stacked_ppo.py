"""The port's stacked PPO iteration against the jitted JAX stacked iteration
(`madrona_bots_tpu/learn/ppo.py` stacked=True), and against its own loop.

Each case runs one iteration from the same state, stacked train state and
key in both packages at 4 worlds x 32 slots, hidden 32, rollout 3, 2
minibatches, 2 update epochs with the decorrelated minibatch order, 3
learner rows per class: world-state fields bit-exact but `surrounding` and
`hidden`, parameters, Adam state and metrics at the tolerances of
tests/test_torch_ppo.py. The port's stacked iteration against its loop
iteration over 3 iterations: identical integer trajectory (the JAX
package's tests/test_stacked_ppo.py gate). And the stacked PPO optimizer's
state carries over from the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_bots_tpu import EnvConfig as JaxConfig
from madrona_bots_tpu import init_state as jax_init_state
from madrona_bots_tpu.learn import a2c as ja2c
from madrona_bots_tpu.learn import ppo as jppo
from madrona_bots_tpu.models import ActorCritic as JaxAC
from madrona_bots_tpu.models import SpeciesNetGenerator as JaxGen
from madrona_bots_tpu_torch import init_state, rng
from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.env.state import FIELDS, state_from_numpy, state_to_numpy
from madrona_bots_tpu_torch.learn import a2c, ppo
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator
from madrona_bots_tpu_torch.models.stacked import StackedActorCritic
from test_torch_ppo import LR, TOL
from test_torch_state import jax_arrays

NS = 4
KW = dict(num_worlds=4, init_agents=16, max_agents=32)
HIDDEN = 32
SEED = 0            # generator seed 0: depths 2, 3, 2, 1 and GRU, GRU, RNN, LSTM
TRAINER = dict(rollout_len=3, num_minibatches=2, update_epochs=2, decorrelate=True,
               learner_slots_per_class=3, stacked=True)
STEPS = 2 * 2                                    # Adam steps an iteration


def nets(hidden=HIDDEN):
    jgen = JaxGen(69, 6, hidden, 16, seed=SEED)
    tgen = SpeciesNetGenerator(69, 6, hidden, 16, seed=SEED)
    jm = [JaxAC.from_generator(jgen) for _ in range(NS)]
    tm = [ActorCritic.from_generator(tgen) for _ in range(NS)]
    configs = [m.config for m in tm]
    assert {c["recurrent"]["type"] for c in configs} == {"LSTM", "GRU", "RNN"}
    assert len({len(c["layers"]) for c in configs}) > 1
    return jm, tm


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a * b).sum() / (a.norm() * b.norm()))


def run_case(bf: bool):
    """One stacked iteration in each package from the same inputs: (JAX
    state, JAX train state carried to the port, JAX metrics, port state,
    port train state, port metrics, parameters before, the stacked net)."""
    jmodels, tmodels = nets()
    jit, jopt = jppo.make_ppo_trainer(jmodels, JaxConfig(**KW),
                                      compute_dtype=jnp.bfloat16 if bf else None, **TRAINER)
    tit, topt = ppo.make_ppo_trainer(tmodels, EnvConfig(**KW),
                                     compute_dtype=torch.bfloat16 if bf else None, **TRAINER)
    sac = tit.sac

    def carried(ts):
        return sac.train_state_from_jax(jax.tree.map(np.asarray, ts.params),
                                        jax.tree.leaves(ts.opt_state))

    jts = ja2c.init_stacked_train_state(jmodels, jax.random.key(1), jopt)
    tts = carried(jts)
    assert torch.equal(tts.params, a2c.init_stacked_train_state(tmodels, rng.key(1), topt).params)
    before = tts.params.clone()
    js = jax_init_state(jax.random.key(SEED), JaxConfig(**KW))
    ts = state_from_numpy(jax_arrays(js), device="cpu")
    js, jts, jm = jit(js, jts, jax.random.key(31))
    ts, tts, tm = tit(ts, tts, rng.key(31))
    return (jax_arrays(js), carried(jts), {k: float(v) for k, v in jm.items()},
            state_to_numpy(ts), tts, {k: float(v) for k, v in tm.items()}, before, sac)


@pytest.fixture(scope="module")
def results():
    return {}


def get(results, dtype):
    if dtype not in results:
        results[dtype] = run_case(dtype == "bf16")
    return results[dtype]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_state_exact(results, dtype):
    want, _, _, got, _, _, _, _ = get(results, dtype)
    for f in FIELDS:
        if f not in ("surrounding", "hidden"):
            assert int((want[f] != got[f]).sum()) == 0, (dtype, f)
    np.testing.assert_allclose(got["surrounding"], want["surrounding"], rtol=1e-5, atol=1e-4)
    assert int(got["action"].sum()) > 0 and int(want["step_count"]) == 3


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_hidden_close(results, dtype):
    want, _, _, got, _, _, _, _ = get(results, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(got["hidden"], want["hidden"], rtol=tol["rtol"],
                               atol=tol["mem_atol"])
    assert np.array_equal((got["hidden"] != 0).any(-1), (want["hidden"] != 0).any(-1))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_params_and_moments_close(results, dtype):
    _, j, _, _, t, _, p0, sac = get(results, dtype)
    tol = TOL[dtype]
    assert int(t.opt_state.count) == int(j.opt_state.count) == STEPS
    per = zip(*(sac.unstack_params(x) for x in (
        j.params, t.params, p0, j.opt_state.mu, t.opt_state.mu, j.opt_state.nu,
        t.opt_state.nu)))
    for s, (jp, tp, p, jmu, tmu, jnu, tnu) in enumerate(per):
        diff = (tp - jp).abs()
        moved = float((tp - p).abs().max())
        if dtype == "bf16":
            assert cosine(jp - p, tp - p) >= 0.9, s
            assert moved >= LR, s
            assert float(diff.max()) <= 2 * LR * STEPS, s
            assert float(diff.mean()) < LR / 10 * STEPS, s
            for a, b in ((tmu, jmu), (tnu, jnu)):
                assert cosine(a, b) >= 0.9, s
        else:
            assert moved > 100 * float(diff.max()), s
            assert float(diff.max()) <= 2 * LR, s
            sure = jmu.abs() >= 1e-7
            assert int(sure.sum()) >= 1000
            assert float(diff[sure].max()) <= 1e-6, s
            for a, b in ((tmu, jmu), (tnu, jnu)):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol["rtol"],
                                           atol=tol["moment_atol"] * float(b.abs().max()))
    # The padding never moves.
    pad = torch.ones(sac.num_params, dtype=torch.bool)
    for idx in sac.index:
        pad[idx] = False
    assert int(pad.sum()) > 0 and float(t.params[pad].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_metrics_close(results, dtype):
    _, _, jm, _, _, tm, _, _ = get(results, dtype)
    tol = TOL[dtype]
    assert list(tm) == [f"species_{s}_{k}" for s in range(1, NS + 1)
                        for k in ppo.PER_SPECIES_METRICS] + ["env_steps"]
    assert sorted(tm) == sorted(jm)
    assert sum(tm[f"species_{s}_dropped_rows"] for s in range(1, NS + 1)) > 0
    for k, v in jm.items():
        assert np.isfinite(tm[k]), k
        if k.endswith(("_dropped_rows", "_count", "env_steps")):
            assert tm[k] == v, k
        else:
            assert tm[k] == pytest.approx(v, rel=tol["rtol"], abs=tol["atol"]), k


def test_stacked_ppo_optimizer_state_carries_from_jax():
    """The JAX package's per-species PPO optimizer states, stacked by the
    port, equal its stacked state's leaves; the port's stacked optimizer
    takes them."""
    jmodels, tmodels = nets()
    key = jax.random.key(0)
    jparams = [m.init(jax.random.fold_in(key, i)) for i, m in enumerate(jmodels)]
    opt_l = jppo.make_ppo_optimizer(3e-4)
    states = []
    for s, p in enumerate(jparams):
        g = jax.tree.map(lambda x: 0.01 * jax.random.normal(jax.random.key(3 + s), x.shape), p)
        states.append(opt_l.update(g, opt_l.init(p), p)[1])
    from madrona_bots_tpu.models.stacked import StackedActorCritic as JaxSAC
    jsac = JaxSAC(jmodels)
    sp = jsac.stack_params(jparams)
    want = jax.tree.leaves(jsac.stack_opt_state(states, jparams, sp))
    sac = StackedActorCritic(tmodels)
    got = sac.stack_opt_state([a2c.AdamState(*(torch.from_numpy(np.array(x))
                                                for x in jax.tree.leaves(st)))
                               for st in states])
    assert len(want) == 3
    for a, b in zip(got, want):
        assert torch.equal(a, torch.from_numpy(np.array(b)))
    opt = ppo.make_stacked_ppo_optimizer(sac, 3e-4)
    flat = sac.params_from_jax(jax.tree.map(np.asarray, sp))
    new, st = opt.update(torch.full_like(flat, 0.01), got, flat)
    assert int(st.count) == 2 and bool(torch.isfinite(new).all())


def test_stacked_iterations_track_loop():
    """3 iterations of the port's stacked and loop trainers from the same
    state, parameters and keys: identical integer trajectory."""
    _, models = nets()
    cfg = EnvConfig(num_worlds=8, init_agents=8, max_agents=32)
    kw = dict(rollout_len=4, num_minibatches=2, update_epochs=2, learner_slots_per_class=4)
    it_l, opt_l = ppo.make_ppo_trainer(models, cfg, **kw)
    it_s, opt_s = ppo.make_ppo_trainer(models, cfg, stacked=True, **kw)
    ts_l = a2c.init_train_states(models, rng.key(1), opt_l)
    ts_s = a2c.init_stacked_train_state(models, rng.key(1), opt_s)
    st_l, st_s = init_state(cfg, 0, "cpu"), init_state(cfg, 0, "cpu")
    for t in range(3):
        k = rng.fold_in(rng.key(9), t)
        st_l, ts_l, m_l = it_l(st_l, ts_l, k)
        st_s, ts_s, m_s = it_s(st_s, ts_s, k)
        for f in ("alive", "species", "health", "action", "pos"):
            assert torch.equal(getattr(st_l, f), getattr(st_s, f)), (t, f)
        np.testing.assert_allclose(st_l.hidden.numpy(), st_s.hidden.numpy(), rtol=0, atol=2e-2)
        assert list(m_l) == list(m_s)
        for k_ in m_l:
            np.testing.assert_allclose(float(m_l[k_]), float(m_s[k_]), rtol=5e-3, atol=5e-3,
                                       err_msg=f"iteration {t} metric {k_}")
    for a, b in zip(it_s.sac.unstack_params(ts_s.params), ts_l):
        np.testing.assert_allclose(a.numpy(), b.params.numpy(), rtol=0, atol=2e-3)
