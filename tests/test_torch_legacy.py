"""The port's legacy nets and drivers (`models/legacy.py`, `learn/env.py`,
`learn/env_app.py`) against the JAX package's.

Nets: generator configs and init bits equal, forward / returns / loss within
1e-6. Drivers: three frames of both packages' `env_app.make_train_step` on
their own managers (4 worlds, f32): the first frame's actions and integer
state are equal; parameters agree within 1e-6 where the JAX first moment is
at least 1e-7 and within 2 lr everywhere (XLA:CPU's tanh and fused math
differ from torch's by ulps, which Adam's first steps can blow up to lr on
ill-conditioned coordinates; ROADMAP, notes)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from madrona_bots_tpu.api import SimManager as JaxManager
from madrona_bots_tpu.learn import env_app as jenv_app
from madrona_bots_tpu.models import legacy as jlegacy
from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.api import SimManager
from madrona_bots_tpu_torch.env.state import state_to_numpy
from madrona_bots_tpu_torch.learn import env as legacy_env
from madrona_bots_tpu_torch.learn import env_app
from madrona_bots_tpu_torch.learn.a2c import Adam
from madrona_bots_tpu_torch.models import legacy
from test_torch_state import jax_arrays

LR = 3e-4


def nets(seed, hidden=32, n=4):
    jgen = jlegacy.LegacySpeciesNetGenerator(69, 6, hidden, seed=seed)
    tgen = legacy.LegacySpeciesNetGenerator(69, 6, hidden, seed=seed)
    return ([jlegacy.LegacyActorCritic.from_generator(jgen) for _ in range(n)],
            [legacy.LegacyActorCritic.from_generator(tgen) for _ in range(n)])


@pytest.mark.parametrize("seed", [0, 1, 69])
def test_generator_configs_and_init_bits(seed):
    jm, tm = nets(seed)
    for i, (j, t) in enumerate(zip(jm, tm)):
        assert t.get_config() == j.get_config()
        jp = j.init(jax.random.fold_in(jax.random.key(seed), i))
        tp = t.params_to_jax(t.init(rng.fold_in(rng.key(seed), i)))
        jl, tl = jax.tree.leaves(jp), jax.tree.leaves(tp)
        assert len(jl) == len(tl) == len(t.specs)
        for a, b in zip(jl, tl):
            assert np.asarray(a).tobytes() == b.tobytes()
        back = t.params_to_jax(t.params_from_jax(jp))
        assert all(np.array_equal(a, b) for a, b in zip(jl, jax.tree.leaves(back)))


def test_forward_returns_and_loss():
    jm, tm = nets(3, hidden=64)
    obs = np.random.default_rng(0).standard_normal((37, 69)).astype(np.float32)
    for i, (j, t) in enumerate(zip(jm, tm)):
        jp = j.init(jax.random.key(i))
        logits, value = j.forward(jp, jnp.asarray(obs))
        tl, tv = t(torch.from_numpy(obs), t.params_from_jax(jp))
        assert tl.shape == (37, 6) and tv.shape == (37,)
        np.testing.assert_allclose(tl.detach().numpy(), np.asarray(logits), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tv.detach().numpy(), np.asarray(value), rtol=1e-6, atol=1e-6)
    r = np.random.default_rng(1).standard_normal((9, 5)).astype(np.float32)
    for norm in (False, True):
        want = jlegacy.discounted_returns(jnp.asarray(r), 0.9, norm)
        got = legacy.discounted_returns(torch.from_numpy(r), 0.9, norm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    logp, g, v = (np.random.default_rng(k).standard_normal(50).astype(np.float32) * 2
                  for k in (2, 3, 4))
    want = jlegacy.legacy_loss(jnp.asarray(logp), jnp.asarray(g), jnp.asarray(v))
    got = legacy.legacy_loss(*(torch.from_numpy(x) for x in (logp, g, v)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-6)


def test_env_app_train_step_matches_jax():
    seed, W = 69, 4
    jmods, tmods = nets(seed)
    jmgr = JaxManager(0, W, seed, 32, use_pallas=False)
    tmgr = SimManager(0, W, seed, 32, device="cpu")
    jopt, topt = optax.adam(LR), Adam(LR)
    jparams = [m.init(jax.random.fold_in(jax.random.key(seed), i))
               for i, m in enumerate(jmods)]
    jstates = [jopt.init(p) for p in jparams]
    tparams = [m.flatten(m.init(rng.fold_in(rng.key(seed), i))) for i, m in enumerate(tmods)]
    tstates = [topt.init(p) for p in tparams]
    jstep = jenv_app.make_train_step(jmods, jopt, jparams, jstates, 4,
                                     [jax.random.key(seed + 1)])
    tstep = env_app.make_train_step(tmods, topt, tparams, tstates, 4,
                                    [rng.key(seed + 1)])
    for frame in range(3):
        jstep(jmgr)
        tstep(tmgr)
        if frame == 0:
            want, got = jax_arrays(jmgr.state), state_to_numpy(tmgr.state)
            ints = [f for f in want if want[f].dtype.kind in "iub" and f != "world_keys"]
            assert "action" in ints and "prev_action" in ints
            assert int(want["action"].sum()) == jmgr.total_num_agents
            for f in ints:
                assert np.array_equal(want[f], got[f]), f
    for s, (m, jp, js) in enumerate(zip(tmods, jparams, jstates)):
        got = jax.tree.leaves(m.params_to_jax(m.unflatten(tparams[s])))
        mus = jax.tree.leaves(js[0].mu)
        assert int(tstates[s].count) == int(js[0].count) == 3
        for a, b, mu in zip(got, jax.tree.leaves(jp), mus):
            diff = np.abs(a - np.asarray(b))
            assert diff.max() <= 2 * LR, s
            sure = np.abs(np.asarray(mu)) >= 1e-7
            assert not sure.any() or diff[sure].max() <= 1e-6, (s, diff[sure].max())


def test_legacy_env_driver_runs(capsys):
    params = legacy_env.main(["--num_worlds", "2", "--num_epochs", "2",
                              "--hidden_dim", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Average FPS for simulator:" in out and "epoch 1 pop=" in out
    assert len(params) == 4 and all(bool(torch.isfinite(p).all()) for p in params)


def test_legacy_drivers_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        legacy_env.main(["--num_worlds", "2", "--num_epochs", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        env_app.main(["--num_worlds", "2", "--num_epochs", "1"])
