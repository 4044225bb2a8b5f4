"""The port's species-stacked net and stacked A2C tick against the JAX
package's (`models/stacked.py`, `learn/a2c.py` stacked=True).

Held against the jitted JAX functions on the same inputs (made from seeds
with numpy or carried from the JAX package): `stackable`; the stacked
parameter vector, bit for bit, and its round trips; the stacked forward
(and against the per-species nets) within 1e-5; the stacked Adam moments,
exactly; the per-species gradient clip within rtol 1e-5, atol 1e-7; the
batched categorical draw, exactly; two stacked A2C ticks at the tolerances
of tests/test_torch_a2c.py. And the port's stacked tick against its own
loop tick: the same integer trajectory over 4 ticks, parameters within
2e-3 (the bounds of tests/test_stacked.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_bots_tpu import EnvConfig as JaxConfig
from madrona_bots_tpu import init_state as jax_init_state
from madrona_bots_tpu.learn import a2c as ja2c
from madrona_bots_tpu.models import ActorCritic as JaxAC
from madrona_bots_tpu.models import SpeciesNetGenerator as JaxGen
from madrona_bots_tpu.models import stacked as jstacked
from madrona_bots_tpu_torch import init_state, rng
from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.env.state import FIELDS, state_from_numpy, state_to_numpy
from madrona_bots_tpu_torch.learn import a2c
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator
from madrona_bots_tpu_torch.models.stacked import (StackedActorCritic,
                                                   per_species_clip_by_global_norm, stackable)
from test_torch_a2c import FLOAT_FIELDS, LR, TOL
from test_torch_state import jax_arrays

NS = 4
SEED = 0            # generator seed 0: depths 2, 3, 2, 1 and GRU, GRU, RNN, LSTM
HIDDEN = 32
KW = dict(num_worlds=4, init_agents=32, max_agents=64)
SLOTS = 5


def nets(seed=SEED, hidden=HIDDEN):
    """(JAX models, port models) with the same configs."""
    jgen = JaxGen(69, 6, hidden, 16, seed=seed)
    tgen = SpeciesNetGenerator(69, 6, hidden, 16, seed=seed)
    return ([JaxAC.from_generator(jgen) for _ in range(NS)],
            [ActorCritic.from_generator(tgen) for _ in range(NS)])


def flat_of(tree) -> torch.Tensor:
    """A JAX tree's leaves as one flat f32 vector in leaf order."""
    return torch.cat([torch.from_numpy(np.array(x, dtype=np.float32)).reshape(-1)
                      for x in jax.tree.leaves(tree)])


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a * b).sum() / (a.norm() * b.norm()))


@pytest.fixture(scope="module")
def setup():
    jmodels, tmodels = nets()
    configs = [m.config for m in tmodels]
    depths = {(len(c["layers"]) - 1) // 2 for c in configs}
    assert {c["recurrent"]["type"] for c in configs} == {"LSTM", "GRU", "RNN"}
    assert len(depths) > 1
    key = jax.random.key(0)
    jparams = [m.init(jax.random.fold_in(key, i)) for i, m in enumerate(jmodels)]
    jsac = jstacked.StackedActorCritic(jmodels)
    return dict(jmodels=jmodels, tmodels=tmodels, jparams=jparams, jsac=jsac,
                tsac=StackedActorCritic(tmodels), jstacked=jsac.stack_params(jparams),
                tparams=[flat_of(p) for p in jparams])


@pytest.mark.parametrize("seed", range(6))
def test_stackable_agrees_with_jax(seed):
    jmodels, tmodels = nets(seed)
    want = jstacked.stackable([m.config for m in jmodels])
    assert stackable([m.config for m in tmodels]) == want
    assert want


@pytest.mark.parametrize("fault", ["short_actor", "critic_width", "memory_dim", "cell"])
def test_stackable_rejects_what_jax_rejects(setup, fault):
    configs = [dict(m.config) for m in setup["tmodels"]]
    bad = dict(configs[1])
    if fault == "short_actor":
        bad["actor"] = bad["actor"][:1]
    elif fault == "critic_width":
        bad["critic"] = [dict(bad["critic"][0], out_features=7)] + bad["critic"][1:]
    elif fault == "memory_dim":
        bad["recurrent"] = dict(bad["recurrent"], hidden_dim=8)
    else:
        bad["recurrent"] = dict(bad["recurrent"], type="Elman")
    configs[1] = bad
    assert not jstacked.stackable(configs)
    assert not stackable(configs)
    odd = ActorCritic(setup["tmodels"][1].config)
    odd.config = bad
    with pytest.raises(ValueError, match="stackable"):
        StackedActorCritic([setup["tmodels"][0], odd] + setup["tmodels"][2:])


def test_stack_params_equals_jax_bit_for_bit(setup):
    tsac = setup["tsac"]
    got = tsac.stack_params(setup["tparams"])
    want = flat_of(setup["jstacked"])
    assert tsac.num_params == want.numel()
    assert torch.equal(got, want)
    assert torch.equal(tsac.params_from_jax(jax.tree.map(np.asarray, setup["jstacked"])), want)
    tree = tsac.params_to_jax(got)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(setup["jstacked"])):
        assert a.shape == b.shape and np.array_equal(a, np.asarray(b))
    for a, b in zip(tsac.unstack_params(got), setup["tparams"]):
        assert torch.equal(a, b)
    # A train state goes to the JAX layout and back unchanged.
    ts = a2c.SpeciesTrainState(got, a2c.AdamState(torch.tensor(3, dtype=torch.int32),
                                                  got * 0.5, got * got))
    back = tsac.train_state_from_jax(*tsac.train_state_to_jax(ts))
    assert torch.equal(back.params, got)
    for x, y in zip(back.opt_state, ts.opt_state):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # JAX unstacks the same vector into the same per-species parameters.
    for a, b in zip(setup["jsac"].unstack_params(setup["jstacked"]), setup["tparams"]):
        assert torch.equal(flat_of(a), b)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_jax_and_per_species(setup, dtype):
    tsac, B = setup["tsac"], 193
    g = np.random.default_rng(1)
    obs = (g.normal(size=(NS, B, 69)) * 20).astype(np.float32)
    mem = g.normal(size=(NS, B, 16)).astype(np.float32)
    flat = tsac.stack_params(setup["tparams"])
    cd = None if dtype == "f32" else torch.bfloat16
    got = a2c.policy_forward(tsac, flat, torch.from_numpy(obs), torch.from_numpy(mem), cd)
    if dtype == "f32":
        want = jax.jit(setup["jsac"].forward)(setup["jstacked"], obs, mem)
        for x, y in zip(got, want):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-5)
    for s, m in enumerate(setup["tmodels"]):
        per = a2c.policy_forward(m, setup["tparams"][s], torch.from_numpy(obs[s]),
                                 torch.from_numpy(mem[s]), cd)
        for x, y in zip(got, per):
            if dtype == "f32":
                np.testing.assert_allclose(x[s].numpy(), y.numpy(), rtol=0, atol=1e-5)
            else:          # bf16 products may round at other places: hold to bf16 steps
                np.testing.assert_allclose(x[s].numpy(), y.numpy(), rtol=2e-2, atol=2e-2)


def test_opt_state_stack_exact_and_equal_to_jax(setup):
    """Per-species Adam states with moments from one real update each ->
    stacked -> back, bit-exact; the stacked moments equal the JAX package's
    `stack_opt_state`."""
    jsac, tsac, jparams = setup["jsac"], setup["tsac"], setup["jparams"]
    opt = ja2c.make_optimizer(1e-3)
    jstates = []
    for s, p in enumerate(jparams):
        g = jax.tree.map(lambda x: jax.random.normal(jax.random.key(7 + s), x.shape), p)
        jstates.append(opt.update(g, opt.init(p), p)[1])
    tstates = [a2c.AdamState(*(torch.from_numpy(np.array(x)) for x in jax.tree.leaves(st)))
               for st in jstates]
    got = tsac.stack_opt_state(tstates)
    want = jax.tree.leaves(jsac.stack_opt_state(jstates, jparams, setup["jstacked"]))
    assert int(got.count) == int(want[0]) == 1
    for a, b in ((got.mu, want[1]), (got.nu, want[2])):
        assert torch.equal(a, torch.from_numpy(np.array(b)))
    for a, b in zip(tsac.unstack_opt_state(got), tstates):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("scale", [1e-3, 3.0])
def test_per_species_clip_matches_jax(setup, scale):
    """Small gradients (kept) and large ones (clipped, each species by its
    own norm)."""
    jsac, tsac = setup["jsac"], setup["tsac"]
    grads = [jax.tree.map(lambda x: scale * jax.random.normal(jax.random.key(11 + s), x.shape),
                          p) for s, p in enumerate(setup["jparams"])]
    gst = jsac.stack_params(grads)
    clip = jstacked.per_species_clip_by_global_norm(0.5, NS)
    want = flat_of(jax.jit(lambda g: clip.update(g, clip.init(g))[0])(gst))
    got = per_species_clip_by_global_norm(0.5, tsac)(flat_of(gst))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-7)
    norms = [float(flat_of(g).norm()) for g in grads]
    assert all(n > 0.5 for n in norms) if scale > 1 else all(n < 0.5 for n in norms)
    if scale > 1:
        for a in tsac.unstack_params(got):
            assert float(a.norm()) == pytest.approx(0.5, rel=1e-5)


def test_batched_categorical_equals_vmapped_jax():
    g = np.random.default_rng(3)
    logits = (g.normal(size=(NS, 257, 6)) * 3).astype(np.float32)
    logits[:, :5] = 0.0                                      # ties: first index wins
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(9), i))(jnp.arange(NS))
    want = np.asarray(jax.jit(jax.vmap(jax.random.categorical))(jkeys, logits))
    keys = rng.fold_in(rng.key(9), torch.arange(NS))
    got = rng.categorical(keys, torch.from_numpy(logits)).numpy()
    assert np.array_equal(got, want)
    for s in range(NS):                   # the loop's per-species draws, bit for bit
        assert np.array_equal(rng.categorical(rng.fold_in(rng.key(9), s),
                                              torch.from_numpy(logits[s])).numpy(), got[s])


# ---- the stacked A2C tick against the jitted JAX stacked tick ----

A2C_CASES = {"f32_raw": (False, False), "f32_proper": (False, True),
             "bf16_raw": (True, False), "bf16_proper": (True, True)}


def run_a2c_case(name):
    """Two stacked ticks, from init and then from the JAX package's warm
    state, each from the same inputs in both packages: [(jax state, jax
    train state carried to the port, jax metrics, port state, port train
    state, port metrics, parameters before the tick)]."""
    bf, proper = A2C_CASES[name]
    jmodels, tmodels = nets()
    jcfg, tcfg = JaxConfig(**KW), EnvConfig(**KW)
    kw = dict(proper_log_probs=proper, learner_slots_per_class=SLOTS, stacked=True)
    jtick, jopt = ja2c.make_train_tick(jmodels, jcfg, compute_dtype=jnp.bfloat16 if bf else None,
                                       **kw)
    ttick, topt = a2c.make_train_tick(tmodels, tcfg, compute_dtype=torch.bfloat16 if bf else None,
                                      **kw)
    tsac = StackedActorCritic(tmodels)
    jts = ja2c.init_stacked_train_state(jmodels, jax.random.key(1), jopt)
    init = a2c.init_stacked_train_state(tmodels, rng.key(1), topt)

    def carried(ts):
        return tsac.train_state_from_jax(jax.tree.map(np.asarray, ts.params),
                                         jax.tree.leaves(ts.opt_state))

    assert torch.equal(carried(jts).params, init.params)
    js = jax_init_state(jax.random.key(4), jcfg)
    ticks = []
    for key in (14, 24):
        ts = state_from_numpy(jax_arrays(js), device="cpu")
        tts = carried(jts)
        p0 = tts.params.clone()
        js, jts, jm = jtick(js, jts, jax.random.key(key))
        ts, tts, tm = ttick(ts, tts, rng.key(key))
        ticks.append((jax_arrays(js), carried(jts), {k: float(v) for k, v in jm.items()},
                      state_to_numpy(ts), tts, {k: float(v) for k, v in tm.items()}, p0))
    return ticks, bf, tsac


@pytest.fixture(scope="module")
def a2c_results():
    return {}


def get(results, name):
    if name not in results:
        results[name] = run_a2c_case(name)
    return results[name]


@pytest.mark.parametrize("name", list(A2C_CASES))
def test_stacked_tick_state_exact(a2c_results, name):
    ticks, bf, _ = get(a2c_results, name)
    tol = TOL["bf16" if bf else "f32"]
    for t, (want, _, _, got, _, _, _) in enumerate(ticks):
        for f in FIELDS:
            if f not in FLOAT_FIELDS:
                assert int((want[f] != got[f]).sum()) == 0, (name, t, f)
        for f in ("hidden", "prev_hidden"):
            np.testing.assert_allclose(got[f], want[f], rtol=tol["rtol"],
                                       atol=tol["mem_atol"], err_msg=f)
        for f in ("surrounding", "prev_surrounding"):
            np.testing.assert_allclose(got[f], want[f], rtol=1e-5, atol=1e-4, err_msg=f)
        assert int(got["action"].sum()) > 0


@pytest.mark.parametrize("name", list(A2C_CASES))
def test_stacked_tick_params_and_moments_close(a2c_results, name):
    ticks, bf, tsac = get(a2c_results, name)
    tol = TOL["bf16" if bf else "f32"]
    for step, (_, j, _, _, t, _, p0) in enumerate(ticks, start=1):
        diff = (t.params - j.params).abs()
        assert float(diff.max()) <= 2 * LR, (name, step)
        if bf:
            # bf16 updates by direction, species by species.
            assert float(diff.mean()) < LR / 20, (name, step)
            for s, (dt, dj) in enumerate(zip(tsac.unstack_params(t.params - p0),
                                             tsac.unstack_params(j.params - p0))):
                assert cosine(dt, dj) >= 0.9, (name, step, s)
        else:
            sure = j.opt_state.mu.abs() >= 1e-7
            assert int(sure.sum()) >= 1000
            assert float(diff[sure].max()) <= (1e-6 if step == 1 else 1e-5), (name, step)
        assert int(t.opt_state.count) == int(j.opt_state.count) == step
        for s, (a, b) in enumerate(zip(tsac.unstack_params(t.opt_state.mu),
                                       tsac.unstack_params(j.opt_state.mu))):
            if bf:
                assert cosine(a, b) >= 0.9, (name, step, s)
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol["rtol"],
                                           atol=tol["moment_atol"] * float(b.abs().max()))
        np.testing.assert_allclose(t.opt_state.nu.numpy(), j.opt_state.nu.numpy(),
                                   rtol=tol["rtol"],
                                   atol=tol["moment_atol"] * float(j.opt_state.nu.abs().max()))


@pytest.mark.parametrize("name", list(A2C_CASES))
def test_stacked_tick_metrics_close(a2c_results, name):
    ticks, bf, _ = get(a2c_results, name)
    tol = TOL["bf16" if bf else "f32"]
    for _, _, jm, _, _, tm, _ in ticks:
        assert sorted(tm) == sorted(jm)
        assert list(tm) == [f"species_{s}_{k}" for s in range(1, NS + 1)
                            for k in a2c.METRIC_NAMES]
        assert sum(tm[f"species_{s}_dropped_rows"] for s in range(1, NS + 1)) > 0
        for k, v in jm.items():
            if k.endswith(("_count", "_dropped_rows", "_count_per_world", "_reward",
                           "_avg_health", "_popular_action")):
                assert tm[k] == pytest.approx(v, rel=1e-6, abs=1e-6), k
            else:
                assert tm[k] == pytest.approx(v, rel=tol["rtol"], abs=tol["rtol"]), k


# ---- the port's stacked tick against its own loop tick ----

@pytest.mark.parametrize("proper", [False, True])
def test_stacked_tick_tracks_loop(proper):
    """4 ticks from the same state and parameters: identical integer
    trajectory (same actions from the same per-species keys); memory,
    metrics and parameters within the JAX package's stacked-vs-loop
    bounds."""
    _, models = nets()
    cfg = EnvConfig(num_worlds=8, init_agents=8, max_agents=32)
    kw = dict(lr=1e-3, proper_log_probs=proper, learner_slots_per_class=4)
    tick_l, opt_l = a2c.make_train_tick(models, cfg, **kw)
    tick_s, opt_s = a2c.make_train_tick(models, cfg, stacked=True, **kw)
    ts_l = a2c.init_train_states(models, rng.key(1), opt_l)
    ts_s = a2c.init_stacked_train_state(models, rng.key(1), opt_s)
    sac = StackedActorCritic(models)
    for a, b in zip(sac.unstack_params(ts_s.params), ts_l):
        assert torch.equal(a, b.params)
    st_l, st_s = init_state(cfg, 0, "cpu"), init_state(cfg, 0, "cpu")
    for t in range(4):
        k = rng.fold_in(rng.key(7), t)
        st_l, ts_l, m_l = tick_l(st_l, ts_l, k)
        st_s, ts_s, m_s = tick_s(st_s, ts_s, k)
        for f in ("alive", "species", "health", "action", "pos", "reward"):
            assert torch.equal(getattr(st_l, f), getattr(st_s, f)), (t, f)
        np.testing.assert_allclose(st_l.hidden.numpy(), st_s.hidden.numpy(), rtol=0, atol=2e-3)
        assert list(m_l) == list(m_s)
        for k_ in m_l:
            np.testing.assert_allclose(float(m_l[k_]), float(m_s[k_]), rtol=4e-3, atol=4e-3,
                                       err_msg=f"tick {t} metric {k_}")
    for a, b in zip(sac.unstack_params(ts_s.params), ts_l):
        np.testing.assert_allclose(a.numpy(), b.params.numpy(), rtol=0, atol=2e-3)
    assert int(ts_s.opt_state.count) == 4
