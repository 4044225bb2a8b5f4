"""The port's f32 PPO iteration against the jitted JAX one at the band
configuration, from fresh and from late-training states.

The band configuration is `artifacts/ppo_multiseed_r5.py`'s (and
`tools/lcurve.py`'s `ppo_spec`): 128 slots a world (32 alive at the start),
`SpeciesNetGenerator(obs_dim, 6, 128, 16, seed=0)`, rollout 16, 1 epoch x
8 minibatches, 8 learner slots a class; here in f32. Keys are the band
driver's: iteration i = 25 b + e runs under `split(fold_in(key(0), b),
25)[e]`.

* From `init_state` (the band run's iteration 0) at 48 worlds, the
  smallest width at which the JAX package takes the ladder raycast.
* From the committed late-training slices `tests/data/ppo_late_i1000.npz`
  and `ppo_late_i1400.npz` (worlds 0-47 of the port's f32 seed-0 band run
  at iterations 1,000 and 1,400 with every species' nets and Adam state;
  `tests/late_slices.py` cuts them): two iterations each, teacher-forced
  (each from the JAX package's output of the one before).

JAX runs its spec path (`use_pallas=False`; its bits equal the Pallas
kernels' on every field held exactly here). Tolerances, f32 (those of
tests/test_torch_ppo.py and tests/test_torch_lcurve.py): every world-state
field bit-exact but `surrounding` (SPEC D10: rtol 1e-5, atol 1e-4),
`hidden` (the same rows hold memory; rtol 1e-4, atol 1e-5) and `reward`
(rtol 1e-6, atol 1e-7) and their `prev_` twins; `dropped_rows`, `count`
and `env_steps` exact; parameters within 1e-6 where the JAX first moment
is at least 1e-7 and within 2 lr everywhere; Adam moments within rtol 1e-4
plus 1e-4 of the largest |moment|; other metrics within rel 1e-4, abs
1e-5.

Marked `slow` (run once, by hand: `JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_ppo_band.py -m slow -s`; each prints a `BAND-REPORT` JSON
line): one iteration from `init_state` at 4,096 worlds (the 2^19-row
minibatch roll, world sums at scale); one iteration on each slice with the
JAX Pallas kernels in interpret mode; and 25 iterations free-running from
each slice, each package from its own output, which records the first
iteration where an integer field parts and, at its first tick where an
action differs, the gap between the top two `gumbel + logit` values of
each such agent in each package, and holds each of the port's iterations
against the JAX package's from the port's own inputs (a species whose
update meets a branch point within rounding of its boundary after that
point is put on its other side: `BranchProbe`).
"""

import json
import os
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from madrona_bots_tpu import EnvConfig as JaxConfig
from madrona_bots_tpu.env import env as jenv
from madrona_bots_tpu.env.state import init_state as jax_init_state
from madrona_bots_tpu.learn import a2c as ja2c
from madrona_bots_tpu.learn import ppo as jppo
from madrona_bots_tpu.models import ActorCritic as JaxAC
from madrona_bots_tpu.models import SpeciesNetGenerator as JaxGen
from madrona_bots_tpu.ops import raycast_pallas, step_pallas
from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.config import NUM_ACTIONS, EnvConfig
from madrona_bots_tpu_torch.env import env as tenv
from madrona_bots_tpu_torch.env.state import FIELDS, state_from_numpy, state_to_numpy
from madrona_bots_tpu_torch.learn import a2c, ppo
from madrona_bots_tpu_torch.learn.pack import class_major
from madrona_bots_tpu_torch.models import actor_critic
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator
from late_slices import load_arrays, train_states_of
from test_torch_a2c import jax_train_states_to_port
from test_torch_state import arrays_to_jax, jax_arrays

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SEED, BLOCK, T, M, SLOTS, HIDDEN, LR, NS = 0, 25, 16, 8, 8, 128, 3e-4, 4
W = 48
SLICES = {"i1000": 1000, "i1400": 1400}
# Fields held by a tolerance (the rest bit-exact), as tests/test_torch_lcurve.py.
SURROUNDING = ("surrounding", "prev_surrounding")
MEMORY = ("hidden", "prev_hidden")
REWARD = ("reward", "prev_reward")
EXACT_METRICS = ("_dropped_rows", "_count", "env_steps")


def band_key(it: int, jax_side: bool):
    """The band driver's key of iteration `it`."""
    b, e = divmod(it, BLOCK)
    if jax_side:
        return jax.random.split(jax.random.fold_in(jax.random.key(SEED), b), BLOCK)[e]
    return rng.split(rng.fold_in(rng.key(SEED), b), BLOCK)[e]


class Band:
    """Both packages' f32 PPO trainers at the band configuration and
    `worlds` worlds. States travel as numpy arrays (`jax_arrays` layout),
    train states as the port's tensors."""

    def __init__(self, worlds: int, use_pallas: bool = False, lr: float = LR):
        kw = dict(num_worlds=worlds, init_agents=32, max_agents=128)
        self.jcfg, self.tcfg = JaxConfig(**kw), EnvConfig(**kw)
        jgen = JaxGen(self.jcfg.obs_dim, 6, HIDDEN, self.jcfg.hidden_state_dim, seed=SEED)
        tgen = SpeciesNetGenerator(self.tcfg.obs_dim, 6, HIDDEN, self.tcfg.hidden_state_dim,
                                   seed=SEED)
        self.jmodels = [JaxAC.from_generator(jgen) for _ in range(NS)]
        self.tmodels = [ActorCritic.from_generator(tgen) for _ in range(NS)]
        trainer = dict(rollout_len=T, num_minibatches=M, update_epochs=1,
                       learner_slots_per_class=SLOTS)
        self.use_pallas = use_pallas
        self.jit, jopt = jppo.make_ppo_trainer(self.jmodels, self.jcfg, use_pallas=use_pallas,
                                               optimizer=jppo.make_ppo_optimizer(lr), **trainer)
        self.tit, _ = ppo.make_ppo_trainer(self.tmodels, self.tcfg,
                                           optimizer=ppo.make_ppo_optimizer(lr), **trainer)
        self.jts0 = ja2c.init_train_states(self.jmodels, jax.random.key(SEED), jopt)
        self.jstate0 = jax_init_state(jax.random.key(SEED + 1000), self.jcfg)

    def start(self):
        """The band run's iteration-0 inputs: (state arrays, train states)."""
        return jax_arrays(self.jstate0), jax_train_states_to_port(self.tmodels, self.jts0)

    def jax_train_states(self, tts):
        out = []
        for m, tmpl, t in zip(self.tmodels, self.jts0, tts):
            params = jax.tree.unflatten(jax.tree.structure(tmpl.params),
                                        [jnp.asarray(x.numpy()) for x in m.unflatten(t.params)])
            opt = jax.tree.unflatten(jax.tree.structure(tmpl.opt_state),
                                     [jnp.asarray(x.numpy()) for x in t.opt_state])
            out.append(ja2c.SpeciesTrainState(params, opt))
        return tuple(out)

    def jax_iteration(self, arrays, tts, it):
        js = arrays_to_jax(arrays, self.jstate0)
        if self.use_pallas:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(step_pallas, "fused_step_systems",
                           partial(step_pallas.fused_step_systems, interpret=True))
                mp.setattr(raycast_pallas, "raycast_pallas",
                           partial(raycast_pallas.raycast_pallas, interpret=True))
                js, jts, jm = self.jit(js, self.jax_train_states(tts), band_key(it, True))
        else:
            js, jts, jm = self.jit(js, self.jax_train_states(tts), band_key(it, True))
        return (jax_arrays(js), jax_train_states_to_port(self.tmodels, jts),
                {k: float(v) for k, v in jm.items()})

    def port_iteration(self, arrays, tts, it):
        tts = tuple(a2c.SpeciesTrainState(t.params.clone(), a2c.AdamState(
            *(x.clone() for x in t.opt_state))) for t in tts)
        ts, tts, tm = self.tit(state_from_numpy(arrays, "cpu"), tts, band_key(it, False))
        return state_to_numpy(ts), tts, {k: float(v) for k, v in tm.items()}


def load_slice(name):
    """(state arrays, train states) of a committed slice, on the CPU."""
    state, nets = load_arrays(os.path.join(DATA, f"ppo_late_{name}.npz"))
    return state, train_states_of(nets)


# ---- the checks, shared by every case ----

def integer_fields_apart(want, got):
    """The fields held bit-exact that differ, with their counts."""
    return {f: int((want[f] != got[f]).sum()) for f in FIELDS
            if f not in SURROUNDING + MEMORY + REWARD and (want[f] != got[f]).any()}


def check_state(want, got):
    assert integer_fields_apart(want, got) == {}
    for f in SURROUNDING:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-5, atol=1e-4, err_msg=f)
    for f in MEMORY:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-5, err_msg=f)
        assert np.array_equal((got[f] != 0).any(-1), (want[f] != 0).any(-1)), f
    for f in REWARD:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-6, atol=1e-7, err_msg=f)


def param_gaps(jts, tts):
    """Per species: (max |diff|, max |diff| where the JAX first moment is
    at least 1e-7, how many such)."""
    out = []
    for j, t in zip(jts, tts):
        diff = (t.params - j.params).abs()
        sure = j.opt_state.mu.abs() >= 1e-7
        out.append((float(diff.max()), float(diff[sure].max()), int(sure.sum())))
    return out


def check_species(j, t):
    """One species' train state `t` against the JAX package's `j`."""
    ((worst, worst_sure, n_sure),) = param_gaps((j,), (t,))
    assert worst <= 2 * LR and n_sure >= 1000 and worst_sure <= 1e-6, (worst, worst_sure, n_sure)
    assert int(t.opt_state.count) == int(j.opt_state.count)
    for a, b in ((t.opt_state.mu, j.opt_state.mu), (t.opt_state.nu, j.opt_state.nu)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


def species_within(j, t) -> bool:
    try:
        check_species(j, t)
    except AssertionError:
        return False
    return True


def check_train_states(jts, tts):
    for j, t in zip(jts, tts):
        check_species(j, t)


def check_metrics(jm, tm):
    assert list(tm) == [f"species_{s}_{k}" for s in range(1, NS + 1)
                        for k in ppo.PER_SPECIES_METRICS] + ["env_steps"]
    assert sorted(tm) == sorted(jm)
    for k, v in jm.items():
        assert np.isfinite(tm[k]), k
        if k.endswith(EXACT_METRICS):
            assert tm[k] == v, k
        else:
            assert tm[k] == pytest.approx(v, rel=1e-4, abs=1e-5), k


def report(kind, **fields):
    print("BAND-REPORT " + json.dumps(dict(kind=kind, **fields)), flush=True)


def teacher_forced(band, arrays, tts, first_it, n):
    """`n` iterations from (arrays, tts) at iteration `first_it`, each from
    the JAX package's output of the one before: [(JAX out, port out,
    inputs' Adam count)]."""
    out = []
    for it in range(first_it, first_it + n):
        j = band.jax_iteration(arrays, tts, it)
        p = band.port_iteration(arrays, tts, it)
        out.append((j, p, int(tts[0].opt_state.count)))
        arrays, tts = j[0], j[1]
    return out


# ---- the default run: 48 worlds, spec path ----

STEPS = [("init", 0), ("i1000", 0), ("i1000", 1), ("i1400", 0), ("i1400", 1)]


@pytest.fixture(scope="module")
def band48():
    return Band(W)


@pytest.fixture(scope="module")
def results(band48):
    cache = {}

    def get(case):
        if case not in cache:
            if case == "init":
                # lr 0: the update's 8 steps see the fresh nets (see
                # test_fresh_update_within_each_packages_own_sensitivity).
                lr0 = Band(W, lr=0.0)
                cache[case] = teacher_forced(lr0, *lr0.start(), 0, 1)
            else:
                cache[case] = teacher_forced(band48, *load_slice(case), SLICES[case], 2)
            report("teacher_forced", case=case, steps=[dict(
                apart=integer_fields_apart(j[0], p[0]), params=param_gaps(j[1], p[1]),
                metrics_share_of_tol=max(abs(p[2][k] - v) / (1e-5 + 1e-4 * abs(v))
                                         for k, v in j[2].items()))
                for j, p, _ in cache[case]])
        return cache[case]
    return get


def one_ulp(tts, seed=0):
    """The train states with every parameter moved one ulp up or down."""
    r = np.random.default_rng(seed)
    out = []
    for t in tts:
        p = t.params.numpy()
        to = np.where(r.random(p.shape) < 0.5, np.float32(np.inf), np.float32(-np.inf))
        out.append(a2c.SpeciesTrainState(torch.from_numpy(np.nextafter(p, to)), t.opt_state))
    return tuple(out)


def test_fresh_update_within_each_packages_own_sensitivity(band48):
    """The band iteration from `init_state` at the band's lr: its 8 Adam
    steps from a fresh Adam state are ill-conditioned for species 3 and 4
    (RNN, LSTM), so a parameter moved by one ulp moves the JAX package's
    own result past the f32 rules (~8e-4 in species 4). The case `init`
    above therefore runs it at lr 0 (every minibatch's loss and gradient on
    the fresh nets, held to the rules). Here, at lr 3e-4: the world state
    and the population metrics are exact, and each species' port-vs-JAX
    parameter gap is within 1.5x the largest gap that either package makes
    to its own result when every input parameter moves one ulp (seeds 0
    and 1), and within 1.5e-6 where that is below 1e-6."""
    arrays, tts = band48.start()
    j, p = band48.jax_iteration(arrays, tts, 0), band48.port_iteration(arrays, tts, 0)
    assert integer_fields_apart(j[0], p[0]) == {}
    for k in j[2]:
        if k.endswith(EXACT_METRICS + ("_reward",)):
            assert p[2][k] == pytest.approx(j[2][k], rel=1e-6, abs=1e-6), k
    own = []                                  # per seed, JAX then the port: per species
    for seed in (0, 1):
        moved = one_ulp(tts, seed)
        own.append([g[0] for g in param_gaps(j[1], band48.jax_iteration(arrays, moved, 0)[1])])
        own.append([g[0] for g in param_gaps(p[1], band48.port_iteration(arrays, moved, 0)[1])])
    gaps = param_gaps(j[1], p[1])
    report("fresh_update_sensitivity", port_jax=[g[0] for g in gaps], own_one_ulp=own)
    for s in range(NS):
        bound = 1.5 * max(max(o[s] for o in own), 1e-6)
        assert gaps[s][0] <= bound, (s + 1, gaps[s][0], bound)
    assert max(g[1] for g in gaps) > 1e-6, gaps          # the rule's 1e-6 cannot hold


def test_slices_are_the_band_runs_late_states():
    """Each slice holds 48 worlds of the f32 seed-0 band run at its
    iteration: 16 env steps and 8 Adam steps an iteration, 32 alive agents
    a world (the population floor)."""
    with open(os.path.join(DATA, "ppo_late.json")) as f:
        meta = json.load(f)
    assert meta["spec"] == dict(objective="ppo", seed=SEED, steps=1500, worlds=8192,
                                block=BLOCK, slots=SLOTS, hidden=HIDDEN, dtype="f32",
                                rollout=T)
    assert meta["worlds"] == [0, W]
    for name, it in SLICES.items():
        assert meta["slices"][f"ppo_late_{name}.npz"]["iteration"] == it
        state, tts = load_slice(name)
        assert int(state["step_count"]) == T * it
        assert state["alive"].shape == (W, 128) and int(state["alive"].sum()) >= 32 * W
        assert [int(t.opt_state.count) for t in tts] == [M * it] * NS


@pytest.mark.parametrize("case,k", STEPS)
def test_state_exact(results, case, k):
    (want, _, _), (got, _, _), _ = results(case)[k]
    check_state(want, got)
    assert int(got["step_count"]) == int(want["step_count"])


@pytest.mark.parametrize("case,k", STEPS)
def test_params_and_moments_close(results, case, k):
    (_, jts, _), (_, tts, _), count = results(case)[k]
    assert int(jts[0].opt_state.count) == count + M
    check_train_states(jts, tts)
    if case == "init":                     # lr 0: the moments hold every gradient
        assert all(torch.equal(t.params, j.params) for j, t in zip(jts, tts))


@pytest.mark.parametrize("case,k", STEPS)
def test_metrics_close(results, case, k):
    (_, _, jm), (_, _, tm), _ = results(case)[k]
    check_metrics(jm, tm)
    assert jm["env_steps"] == T * W


# ---- slow: run once, results in PERF.md ----

@pytest.mark.slow
def test_band_width_from_init():
    """One iteration at 4,096 worlds from `init_state` (the band's 8,192
    halved to keep both packages' f32 iteration within the CPU host's
    shared memory): the minibatch roll over 2^19 rows a species and world
    sums at scale. At lr 0, as the `init` case, so that every minibatch's
    gradient is held on the fresh nets."""
    import resource
    worlds = 4096
    t0 = time.perf_counter()
    band = Band(worlds, lr=0.0)
    (want, jts, jm), (got, tts, tm), _ = teacher_forced(band, *band.start(), 0, 1)[0]
    report("band_width", worlds=worlds, rows_a_species=T * worlds * SLOTS,
           apart=integer_fields_apart(want, got), params=param_gaps(jts, tts),
           moments=[float((t.opt_state.mu - j.opt_state.mu).abs().max()
                          / j.opt_state.mu.abs().max()) for j, t in zip(jts, tts)],
           metrics={k: (jm[k], tm[k]) for k in jm},
           peak_rss_gib=round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, 2),
           seconds=round(time.perf_counter() - t0, 1))
    check_state(want, got)
    check_train_states(jts, tts)
    check_metrics(jm, tm)


@pytest.mark.slow
@pytest.mark.parametrize("case", list(SLICES))
def test_pallas_path_on_slice(case):
    """One iteration on each slice with the JAX Pallas kernels (systems,
    ladder raycast) in interpret mode."""
    t0 = time.perf_counter()
    band = Band(W, use_pallas=True)
    (want, jts, jm), (got, tts, tm), _ = teacher_forced(band, *load_slice(case),
                                                        SLICES[case], 1)[0]
    report("pallas", case=case, apart=integer_fields_apart(want, got),
           params=param_gaps(jts, tts), seconds=round(time.perf_counter() - t0, 1))
    check_state(want, got)
    check_train_states(jts, tts)
    check_metrics(jm, tm)


def jax_tick_fn(band):
    """One rollout tick of the JAX iteration's body (`learn/ppo.py`
    `policy_step` and `env_body`, f32, spec path), also returning every
    species' logits and Gumbel draws [NS, W * A / NS, 6]."""
    cfg, models = band.jcfg, band.jmodels

    @jax.jit
    def tick(state, params, k_act):
        W_, A = state.alive.shape
        Asub, H = A // NS, state.hidden.shape[-1]
        obs = jppo._flat_obs(state.sensor_depth, state.health, state.pos,
                             state.sensor_semantic, state.surrounding)
        obs4 = obs.reshape(W_, Asub, NS, -1)
        mem4 = state.hidden.reshape(W_, Asub, NS, H)
        alive3 = state.alive.reshape(W_, Asub, NS)
        sp3 = state.species.reshape(W_, Asub, NS)
        acts, hs, lgs, gbs = [], [], [], []
        for s in range(NS):
            mb = (alive3[:, :, s] & (sp3[:, :, s] == s + 1)).reshape(-1)
            logits, _, h = models[s].forward(params[s], obs4[:, :, s].reshape(W_ * Asub, -1),
                                             mem4[:, :, s].reshape(W_ * Asub, H))
            g = jax.random.gumbel(jax.random.fold_in(k_act, s), logits.shape)
            a = jax.random.categorical(jax.random.fold_in(k_act, s), logits)
            acts.append(jnp.where(mb, a, 0).reshape(W_, Asub))
            hs.append((h * mb[:, None].astype(h.dtype)).reshape(W_, Asub, H))
            lgs.append(logits)
            gbs.append(g)
        action = jnp.stack(acts, axis=2).reshape(W_, A)
        onehot = jax.nn.one_hot(action, NUM_ACTIONS, dtype=jnp.int32)
        state = state.replace(action=onehot * state.alive[..., None],
                              hidden=jnp.stack(hs, axis=2).reshape(state.hidden.shape))
        state = jenv.sensor_pass(jenv.step_systems(state, cfg, False), cfg, False)
        return state, action, jnp.stack(lgs), jnp.stack(gbs)
    return tick


def port_tick(band, state, params, k_act):
    """One rollout tick of the port's iteration (`PPOTrainer.policy_step`
    and the env step), also returning every species' logits and Gumbel
    draws [NS, W * A / NS, 6]."""
    tr = band.tit
    action, _, _, new_hidden, obs = tr.policy_step(params, state, k_act)
    Wn = state.alive.shape[0]
    with torch.no_grad():
        lg = torch.stack([a2c.policy_forward(m, p, o, h)[0] for m, p, o, h in zip(
            tr.models, params,
            class_major(obs, NS).reshape(NS, Wn * tr.Asub, -1),
            class_major(state.hidden, NS).reshape(NS, Wn * tr.Asub, -1))])
    gb = torch.stack([rng.gumbel(rng.fold_in(k_act, s), lg.shape[1:]) for s in range(NS)])
    onehot = F.one_hot(action, NUM_ACTIONS).to(torch.int32) * state.alive[..., None]
    state = tenv.step(state.replace(action=onehot, hidden=new_hidden), tr.cfg, True)
    return state, action, lg, gb


def rel_gap(z):
    """(top - second) / |top| of each row's values."""
    top2 = np.sort(z, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) / np.abs(top2[..., 1])


def where_actions_part(band, j_in, p_in, it, j_out, p_out):
    """Replays iteration `it` tick by tick in both packages from their own
    inputs (arrays, train states): the first tick where a sampled action
    differs, and for each such agent (world, slot) its action and relative
    top-two gap of `gumbel + logit` in each package; also the integer
    fields where each replay's last tick parts from its package's
    iteration output `j_out` / `p_out` (none: the replay is faithful)."""
    tick = jax_tick_fn(band)
    js = arrays_to_jax(j_in[0], band.jstate0)
    jparams = [ts.params for ts in band.jax_train_states(j_in[1])]
    pstate = state_from_numpy(p_in[0], "cpu")
    pparams = [t.params for t in p_in[1]]
    jkey, pkey = band_key(it, True), band_key(it, False)
    first = None
    Asub = 128 // NS
    for t in range(T):
        jkey, jk = jax.random.split(jkey)
        pkey, pk = rng.split(pkey, 2)
        js, ja, jl, jg = tick(js, jparams, jk)
        pstate, pa, pl, pg = port_tick(band, pstate, pparams, pk)
        ja, pa = np.asarray(ja), pa.numpy()
        if first is None and (ja != pa).any():
            zj, zp = np.asarray(jl + jg), (pl + pg).numpy()
            agents = []
            for w, slot in np.argwhere(ja != pa):
                s, r = slot % NS, w * Asub + slot // NS
                agents.append(dict(world=int(w), slot=int(slot), species=int(s + 1),
                                   jax_action=int(ja[w, slot]), port_action=int(pa[w, slot]),
                                   jax_gap=float(rel_gap(zj[s, r])),
                                   port_gap=float(rel_gap(zp[s, r]))))
            first = dict(tick=t, agents=agents)
    return (first, integer_fields_apart(jax_arrays(js), j_out),
            integer_fields_apart(state_to_numpy(pstate), p_out))


def apart_from_jax(j, p) -> list:
    """What of the port's iteration output `p` lies outside the f32 rules
    against the JAX package's `j` from the same inputs (empty: held)."""
    bad = []
    for name, fn, args in (("state", check_state, (j[0], p[0])),
                           ("train states", check_train_states, (j[1], p[1])),
                           ("metrics", check_metrics, (j[2], p[2]))):
        try:
            fn(*args)
        except AssertionError as e:
            bad.append(f"{name}: {str(e)[:300]}")
    return bad


# ---- branch points: where an update's gradient jumps ----

KINKS = {"ReLU": 0.0, "LeakyReLU": 0.01}          # each kink's slope below 0


def ulps(x):
    """The spacing of f32 numbers at |x|."""
    x = x.abs().float()
    return torch.nextafter(x, torch.full_like(x, float("inf"))) - x


class BranchProbe:
    """The port's update of one species (its 8 Adam steps) on the buffers of
    an iteration's rollout, replayed with every branch point its rows meet
    recorded with the distance to its boundary, or with chosen branch
    points put on their other side. At a branch point the loss's gradient
    jumps as an input crosses a boundary:

    * `value`, the clipped value loss (`learn/ppo.py` `loss`, `v_loss`): a
      row's value gradient is on inside |v - v_old| < clip_eps, and outside
      where the unclipped square wins the max, else off. Distance: to
      |v - v_old| = clip_eps in ulps of max(|v|, |v_old|), and outside also
      to the max's tie in ulps of the unclipped square;
    * `ratio`, the policy ratio's clip: a row's policy gradient is on while
      the ratio lies inside 1 + clip_eps (advantage > 0) or 1 - clip_eps
      (advantage < 0). Distance in ulps of max(|logp|, |logp_old|), times
      the bound;
    * `kink`, a ReLU or LeakyReLU unit of a row, (head, layer, row, unit):
      slope 1 above 0, 0 or 0.01 below. Distance: |z| over its linear
      layer's rounding scale 2^-24 (|x| @ |w| + |b|).

    A point put on its other side changes the gradient only (every value
    keeps its bits); with none moved the replay is the port's update in
    bits (the caller checks)."""

    def __init__(self, band, arrays, tts, it):
        self.tr, self.tts = band.tit, tts
        params = [t.params for t in tts]
        with torch.no_grad():
            state, key, roll = self.tr.rollout(state_from_numpy(arrays, "cpu"), params,
                                               band_key(it, False))
            adv = self.tr.advantages(state, params, key, roll)
            self.bufs, _ = self.tr.update_buffers(roll, adv, key)
            self.moments = self.tr.adv_moments(self.bufs)

    def update(self, s, moved=(), record=False):
        """(species s's train state after its update, its [8, 4] losses,
        [(distance, step, kind, where)] of the nearest branch points of
        each step and place when `record`), with the points `moved` [(step,
        kind, where)] put on their other side."""
        self.moved, self.step = set(moved), 0
        self.points = [] if record else None
        t = self.tts[s]
        ts = a2c.SpeciesTrainState(t.params.clone(), a2c.AdamState(
            *(x.clone() for x in t.opt_state)))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(actor_critic, "_mlp", self.mlp)
            mp.setattr(self.tr, "loss", self.loss)
            out, losses = self.tr.updates(self.tr.models[s], ts, self.bufs[s], self.moments[s])
        return out, losses, self.points

    def note(self, dist, kind, where):
        """The 16 nearest of a step's branch points of one kind and place."""
        if self.points is None:
            return
        valid = self.valid if dist.dim() == 1 else self.valid[:, None]
        d = dist.masked_fill(~valid, float("inf")).reshape(-1)
        vals, idx = torch.topk(d, min(16, d.numel()), largest=False)
        self.points += [(v, self.step, kind, where(i)) for v, i in zip(vals.tolist(),
                                                                      idx.tolist())]

    def moved_here(self, kind, shape, place=None):
        """A mask of this step's moved points of `kind` (at `place`)."""
        mask = torch.zeros(shape, dtype=torch.bool)
        for step, k, where in self.moved:
            if step == self.step and k == kind and (place is None or where[:2] == place):
                mask[where[-len(shape):]] = True
        return mask

    def mlp(self, p, head, layer_cfgs, x):
        """`models/actor_critic.py` `_mlp`, the kinks noted and movable."""
        for i, lc in enumerate(layer_cfgs):
            if lc["type"] == "linear":
                w, b = p[f"{head}.{i}.w"], p[f"{head}.{i}.b"]
                with torch.no_grad():
                    scale = x.abs() @ w.abs() + b.abs()
                x = x @ w + b
                continue
            name, z = lc["activation"], x
            x = actor_critic._ACT[name](z)
            if name not in KINKS or not torch.is_grad_enabled():
                continue
            zd = z.detach()
            units = zd.shape[-1]
            self.note(zd.abs() / (2.0 ** -24 * scale), "kink",
                      lambda i_, h=head, l=i: (h, l) + divmod(i_, units))
            mask = self.moved_here("kink", zd.shape, (head, i))
            if mask.any():
                up = (zd > 0).float()
                natural = up + (1 - up) * KINKS[name]
                other = (1 - up) + up * KINKS[name]
                x = x + mask.float() * (other - natural) * (z - zd)
        return x

    def loss(self, model, flat, picked, moments):
        """`PPOTrainer.loss`, its clips noted and movable."""
        tr = self.tr
        om, a, lp_old, adv, ret, vold, msk = picked
        self.valid = msk
        D, eps = tr.cfg.obs_dim, tr.clip_eps
        w = msk.to(torch.float32)
        denom, mu, var = moments
        adv_n = (adv - mu[..., None]) * torch.rsqrt(var + 1e-8)[..., None]
        logits, v, _ = a2c.policy_forward(model, flat, om[..., :D], om[..., D:], tr.cd)
        lsm = F.log_softmax(logits, dim=-1)
        logp = torch.gather(lsm, -1, a.long()[..., None])[..., 0]
        ratio = torch.exp(logp - lp_old)
        pg = -torch.minimum(ratio * adv_n, torch.clamp(ratio, 1 - eps, 1 + eps) * adv_n)
        v_clip = vold + torch.clamp(v - vold, -eps, eps)
        v_loss = 0.5 * torch.maximum((v - ret) ** 2, (v_clip - ret) ** 2)
        with torch.no_grad():
            vd, vcd, rd = v.detach(), v_clip.detach(), ratio.detach()
            dv = (vd - vold).abs()
            v_on = (dv <= eps) | ((vd - ret) ** 2 > (vcd - ret) ** 2)
            bound = torch.where(adv_n > 0, 1 + eps, 1 - eps)
            pg_on = torch.where(adv_n > 0, rd < 1 + eps, rd > 1 - eps)
            to_clip = (dv - eps).abs() / ulps(torch.maximum(vd.abs(), vold.abs()))
            tie = ((vd - ret) ** 2 - (vcd - ret) ** 2).abs() / ulps((vd - ret) ** 2)
            self.note(torch.where(dv > eps, torch.minimum(to_clip, tie), to_clip), "value",
                      lambda r: (r,))
            self.note((rd - bound).abs() / (bound * ulps(torch.maximum(
                logp.detach().abs(), lp_old.abs()))), "ratio", lambda r: (r,))
        for kind, term, on, new in (("value", v_loss, v_on, 0.5 * (v - ret) ** 2),
                                    ("ratio", pg, pg_on, -(ratio * adv_n))):
            mask = self.moved_here(kind, msk.shape)
            if mask.any():
                flipped = term.detach() + (~on).float() * (new - new.detach())
                if kind == "value":
                    v_loss = torch.where(mask, flipped, v_loss)
                else:
                    pg = torch.where(mask, flipped, pg)
        probs = F.softmax(logits, dim=-1)
        ent = -torch.sum(probs * torch.log(torch.clamp(probs, min=1e-12)), dim=-1)
        pg_s = torch.sum(pg * w, dim=-1)
        vl_s = torch.sum(v_loss * w, dim=-1)
        ent_s = torch.sum(ent * w, dim=-1)
        self.step += 1
        loss = (pg_s + tr.vf_coef * vl_s - tr.ent_coef * ent_s) / denom
        return loss, pg_s / denom, vl_s / denom, ent_s / denom


def branches_to(probe, s, want):
    """The branch points of species s's update that, put on their other
    side, make the replayed update agree with `want` (a train state) under
    the f32 rules: of the points within 128 rounding units of their
    boundary (the error bound of an f32 sum of 128 terms), the 64 nearest,
    moved one more at a time (each round keeps the point that closes the
    most of the parameter gap where |mu| >= 1e-7), at most 4. Returns
    (moved points [(distance, step, kind, where)] or None, the gap left)."""
    *_, points = probe.update(s, record=True)
    near = sorted(p for p in points if p[0] <= 128)[:64]
    moved, left = [], param_gaps((want,), probe.update(s)[:1])[0][1]
    for _ in range(4):
        tries = []
        for p in near:
            if p in moved:
                continue
            ts = probe.update(s, [q[1:] for q in moved + [p]])[0]
            if species_within(want, ts):
                return moved + [p], param_gaps((want,), (ts,))[0][1]
            tries.append((param_gaps((want,), (ts,))[0][1], p))
        gap, p = min(tries)
        if gap >= left:
            break
        moved, left = moved + [p], gap
    return None, left


def test_branch_probe_replays_the_port_update(band48, results):
    """`BranchProbe`, the free-running test's tracer, on species 1's update
    at iteration 1,000 (from the slice): with no point moved it is the
    port's update in bits; putting the last step's nearest branch point on
    its other side changes the parameters through that step's gradient
    alone, every loss keeping its bits."""
    arrays, tts = load_slice("i1000")
    _, port, _ = results("i1000")[0]
    probe = BranchProbe(band48, arrays, tts, SLICES["i1000"])
    ts, losses, points = probe.update(0, record=True)
    assert torch.equal(ts.params, port[1][0].params)
    assert all(torch.equal(a, b) for a, b in zip(ts.opt_state, port[1][0].opt_state))
    assert {(p[1], p[2]) for p in points} >= {(step, kind) for step in range(M)
                                              for kind in ("value", "ratio", "kink")}
    last = min(p for p in points if p[1] == M - 1 and p[2] == "kink")
    moved, moved_losses, _ = probe.update(0, [last[1:]])
    assert torch.equal(moved_losses, losses)
    assert not torch.equal(moved.params, ts.params)


@pytest.mark.slow
@pytest.mark.parametrize("case", list(SLICES))
def test_free_running_is_the_jax_iteration_step_by_step(case):
    """25 iterations from the slice, each package from its own output. The
    first iteration where an integer field parts is recorded and classified
    from that iteration alone by the rule fixed before the first run:
    float drift when every agent whose action differs has a top-two gap
    below 1e-4 relative in both packages and the parameters are within 1e-5
    at its start; anything else a fault to find. Held: each of the port's
    25 iterations, run by the JAX package from the port's own inputs,
    agrees with the port's under the f32 rules, so the port's free-running
    trajectory is, step by step, the JAX package's iteration. Where only a
    species' train state lies outside the rules, its update met a branch
    point (`BranchProbe`) too near its boundary for two roundings to agree
    on its side: the species is held when putting at most 4 of its 64
    nearest branch points within 128 rounding units of their boundary on
    their other side makes the port's update agree with the JAX package's
    under the same f32 rules; the points are reported."""
    t0 = time.perf_counter()
    band = Band(W)
    start = SLICES[case]
    arrays, tts = load_slice(case)
    j_in, p_in = (arrays, tts), (arrays, tts)
    split, jump, per_iter, bad, branched = None, None, [], {}, {}
    for it in range(start, start + BLOCK):
        j_out = band.jax_iteration(*j_in, it)
        p_out = band.port_iteration(*p_in, it)
        forced = band.jax_iteration(*p_in, it)          # JAX on the port's inputs
        outside = apart_from_jax(forced, p_out)
        if outside and not all(o.startswith("train states") for o in outside):
            bad[it] = outside
        elif outside:
            probe = BranchProbe(band, *p_in, it)
            for s, (want, got) in enumerate(zip(forced[1], p_out[1])):
                if species_within(want, got):
                    continue
                assert torch.equal(probe.update(s)[0].params, got.params)
                moved, left = branches_to(probe, s, want)
                branched.setdefault(it, {})[s + 1] = dict(
                    gap=param_gaps((want,), (got,))[0][:2], left=left,
                    moved=moved and [dict(distance=d, step=st, kind=k, where=w)
                                     for d, st, k, w in moved])
                if moved is None:
                    bad.setdefault(it, []).append(f"species {s + 1}: {left}")
        apart = integer_fields_apart(j_out[0], p_out[0])
        gap = max(g[0] for g in param_gaps(j_out[1], p_out[1]))
        per_iter.append(dict(iteration=it, apart=apart, param_max=gap,
                             jax_on_port_inputs=max(g[0] for g in param_gaps(forced[1],
                                                                             p_out[1])),
                             reward=[(j_out[2][f"species_{s}_reward"],
                                      p_out[2][f"species_{s}_reward"])
                                     for s in range(1, NS + 1)]))
        if gap > 1e-5 and jump is None:
            jump = dict(iteration=it, port_vs_jax=[g[0] for g in param_gaps(j_out[1], p_out[1])],
                        jax_vs_jax_on_port_inputs=[g[0] for g in param_gaps(j_out[1],
                                                                            forced[1])],
                        inputs_param_max=max(g[0] for g in param_gaps(j_in[1], p_in[1])))
        if apart and split is None:
            before = max(g[0] for g in param_gaps(j_in[1], p_in[1]))
            first, replay_j, replay_p = where_actions_part(band, j_in, p_in, it, j_out[0],
                                                           p_out[0])
            drift = (first is not None and before <= 1e-5 and replay_j == {} and replay_p == {}
                     and all(a["jax_gap"] < 1e-4 and a["port_gap"] < 1e-4
                             for a in first["agents"]))
            split = dict(iteration=it, after=it - start, fields=apart, params_before=before,
                         first_action_split=first, replay_apart=(replay_j, replay_p),
                         verdict="float drift" if drift else "fault to find")
        j_in, p_in = j_out[:2], p_out[:2]
    report("free_running", case=case, split=split, jump=jump, branched=branched,
           outside_rules=bad, iterations=per_iter, seconds=round(time.perf_counter() - t0, 1))
    assert bad == {}, bad
