"""The port's generator, ActorCritic and compute_loss against the JAX
package's: the same configs from the same seed, the same init bits, the
same forward and the same loss gradients within f32 tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_bots_tpu.models import ActorCritic as JaxAC
from madrona_bots_tpu.models import SpeciesNetGenerator as JaxGen
from madrona_bots_tpu.models.actor_critic import compute_loss as jax_compute_loss
from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic, compute_loss
from madrona_bots_tpu_torch.models.generator import (ACTIVATIONS, RECURRENT_TYPES,
                                                     SpeciesNetGenerator)

OBS, ACT, HID, MEM = 69, 6, 32, 16
FWD_RTOL = 1e-5
# Matmul sums are taken in another order than XLA's, so the absolute error
# grows with the size of the summands: inputs of scale 1 are held within
# 1e-6, inputs of scale 20 (the size of raw observation columns) 2e-5.
FWD_ATOL = {1.0: 1e-6, 20.0: 2e-5}


def configs(seed, n=4):
    jg, tg = JaxGen(OBS, ACT, HID, MEM, seed=seed), SpeciesNetGenerator(OBS, ACT, HID, MEM, seed=seed)
    return [(jg.sample_config(), tg.sample_config()) for _ in range(n)]


def inputs(seed, n=64, scale=20.0):
    r = np.random.default_rng(seed)
    return ((r.normal(size=(n, OBS)) * scale).astype(np.float32),
            r.normal(size=(n, MEM)).astype(np.float32))


def test_generator_configs_equal_and_cover_everything():
    seen_cells, seen_acts = set(), set()
    for seed in range(10):
        for jc, tc in configs(seed):
            assert jc == tc
            seen_cells.add(tc["recurrent"]["type"])
            seen_acts.update(lc["activation"] for lc in tc["layers"]
                             if lc["type"] == "activation")
    assert seen_cells == set(RECURRENT_TYPES)
    assert seen_acts == set(ACTIVATIONS)


@pytest.mark.parametrize("seed", range(10))
def test_init_bit_equal(seed):
    for s, (jc, tc) in enumerate(configs(seed)):
        jp = JaxAC(jc).init(jax.random.fold_in(jax.random.key(seed), s))
        model = ActorCritic(tc)
        leaves = model.init(rng.fold_in(rng.key(seed), s))
        jl = jax.tree.leaves(jp)
        assert [tuple(x.shape) for x in jl] == [s_ for _, s_ in model.specs]
        for a, b in zip(jl, leaves):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        # The JAX tree round-trips through the port's leaf order.
        back = model.params_from_jax(model.params_to_jax(leaves))
        assert all(torch.equal(a, b) for a, b in zip(back, leaves))
        assert jax.tree.structure(jax.tree.map(jnp.asarray, model.params_to_jax(leaves))) \
            == jax.tree.structure(jp)


@pytest.mark.parametrize("scale", [1.0, 20.0])
@pytest.mark.parametrize("seed", range(10))
def test_forward_matches_on_carried_params(seed, scale):
    obs, mem = inputs(seed, scale=scale)
    for s, (jc, tc) in enumerate(configs(seed)):
        jm = JaxAC(jc)
        jp = jm.init(jax.random.fold_in(jax.random.key(100 + seed), s))
        model = ActorCritic(tc)
        model.load_leaves(model.params_from_jax(jp))
        want = jax.jit(jm.forward)(jp, jnp.asarray(obs), jnp.asarray(mem))
        with torch.no_grad():
            got = model(torch.from_numpy(obs), torch.from_numpy(mem))
        for name, w, g in zip(("logits", "value", "memory"), want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FWD_RTOL,
                                       atol=FWD_ATOL[scale],
                                       err_msg=f"{tc['recurrent']['type']} {name}")


@pytest.mark.parametrize("proper", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_loss_grads_match_jax_grad(seed, proper):
    """d(actor + critic)/d(params) of the A2C loss through the net, with a
    D9-style mask, within 1e-5 of jax.grad."""
    obs, mem = inputs(seed, scale=1.0)
    obs_p, mem_p = inputs(seed + 50, scale=1.0)
    r = np.random.default_rng(seed)
    rew = r.normal(size=64).astype(np.float32)
    act = r.integers(0, ACT, 64)
    mask = (r.random(64) < 0.8).astype(np.float32)
    for s, (jc, tc) in enumerate(configs(seed)):
        jm = JaxAC(jc)
        jp = jm.init(jax.random.fold_in(jax.random.key(7), s))
        _, jv_new, _ = jm.forward(jp, jnp.asarray(obs), jnp.asarray(mem))

        def jloss(p):
            lo, v, _ = jm.forward(p, jnp.asarray(obs_p), jnp.asarray(mem_p))
            lp = jax.nn.log_softmax(lo, axis=-1) if proper else lo
            lp = jnp.take_along_axis(lp, jnp.asarray(act)[:, None], axis=1)[:, 0]
            a, c = jax_compute_loss(lp, jnp.asarray(rew), v, jv_new, gamma=0.99,
                                    mask=jnp.asarray(mask))
            return a + c

        jg = jax.tree.leaves(jax.jit(jax.grad(jloss))(jp))
        model = ActorCritic(tc)
        leaves = [t.requires_grad_(True) for t in model.params_from_jax(jp)]
        with torch.no_grad():
            _, v_new, _ = model(torch.from_numpy(obs), torch.from_numpy(mem), leaves)
        lo, v, _ = model(torch.from_numpy(obs_p), torch.from_numpy(mem_p), leaves)
        lp = torch.log_softmax(lo, dim=-1) if proper else lo
        lp = torch.gather(lp, 1, torch.from_numpy(act)[:, None])[:, 0]
        a, c = compute_loss(lp, torch.from_numpy(rew), v, v_new, gamma=0.99,
                            mask=torch.from_numpy(mask))
        tg = torch.autograd.grad(a + c, leaves)
        for (name, _), w, g in zip(model.specs, jg, tg):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def test_bf16_forward_close():
    obs, mem = inputs(3, scale=1.0)
    (jc, tc), = configs(3, n=1)
    jm = JaxAC(jc)
    jp = jm.init(jax.random.key(3))
    cast = lambda t: jax.tree.map(lambda x: x.astype(jnp.bfloat16), t)
    want = jax.jit(jm.forward)(cast(jp), jnp.asarray(obs, jnp.bfloat16),
                               jnp.asarray(mem, jnp.bfloat16))
    model = ActorCritic(tc)
    leaves = [t.to(torch.bfloat16) for t in model.params_from_jax(jp)]
    with torch.no_grad():
        got = model(torch.from_numpy(obs).to(torch.bfloat16),
                    torch.from_numpy(mem).to(torch.bfloat16), leaves)
    for w, g in zip(want, got):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   rtol=5e-2, atol=5e-2)
