"""init_state is bit-exact against the JAX init_state, and the numpy
round-trip carries a state across the two packages unchanged."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from madrona_bots_tpu import EnvConfig as JaxConfig
from madrona_bots_tpu import init_state as jax_init_state
from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.env.state import (FIELDS, init_state, state_from_numpy,
                                              state_to_numpy)

CONFIGS = [dict(num_worlds=4, init_agents=32, max_agents=64),
           dict(num_worlds=3, init_agents=8, max_agents=16, num_chunks_x=5,
                num_chunks_y=3, total_allowed_food=11),
           dict(num_worlds=2, init_agents=12, max_agents=24, num_species=2)]


def jax_arrays(state) -> dict:
    """A JAX WorldState as numpy arrays under the port's field names."""
    out = {}
    for f in FIELDS:
        v = getattr(state, f)
        out[f] = np.asarray(jax.random.key_data(v) if f == "world_keys" else v)
    return out


def arrays_to_jax(arrays: dict, like):
    """Numpy arrays back into a JAX WorldState shaped like `like`."""
    changes = {f: jnp.asarray(arrays[f]) for f in FIELDS if f != "world_keys"}
    changes["world_keys"] = jax.random.wrap_key_data(jnp.asarray(arrays["world_keys"]))
    return like.replace(**changes)


def assert_arrays_equal(want: dict, got: dict, ctx="", tol_fields=()):
    for f in FIELDS:
        a, b = want[f], got[f]
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, f, a.dtype, b.dtype)
        if f in tol_fields:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4, err_msg=f"{ctx} {f}")
        else:
            bad = np.argwhere(a != b)
            assert bad.size == 0, (f"{ctx} field {f}: {bad.shape[0]} mismatches, "
                                   f"first at {bad[0]}: jax={a[tuple(bad[0])]} "
                                   f"port={b[tuple(bad[0])]}")


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("seed", [0, 42])
def test_init_state_bit_exact(kw, seed):
    want = jax_arrays(jax_init_state(jax.random.key(seed), JaxConfig(**kw)))
    got = state_to_numpy(init_state(EnvConfig(**kw), seed, device="cpu"))
    assert_arrays_equal(want, got, f"seed {seed}")


def test_numpy_round_trip():
    js = jax_init_state(jax.random.key(3), JaxConfig(**CONFIGS[0]))
    arrays = jax_arrays(js)
    ts = state_from_numpy(arrays, device="cpu")
    assert_arrays_equal(arrays, state_to_numpy(ts), "to port")
    back = jax_arrays(arrays_to_jax(state_to_numpy(ts), js))
    assert_arrays_equal(arrays, back, "back to jax")


def test_clone_is_independent():
    s = init_state(EnvConfig(**CONFIGS[0]), 0, device="cpu")
    c = s.clone()
    c.pos.add_(1.0)
    c.alive.fill_(False)
    assert not np.array_equal(s.pos.numpy(), c.pos.numpy())
    assert bool(s.alive.any())
