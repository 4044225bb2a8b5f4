"""The port's `Packer`, `gather_rows`, `scatter_rows`, `taa_gather` and
`taa_scatter` against the JAX package's `learn/pack.py`: the same inputs,
made from a seed with numpy, give the same bits (tests/test_pack.py's
cases, the empty group of its last test included)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_bots_tpu.learn import pack as jpack
from madrona_bots_tpu_torch.learn import pack


def bits(x) -> np.ndarray:
    """An array's bits (f32 as uint32, bf16 widened to f32 first)."""
    a = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def permutation_one_hot(rng, G, K, A, empty_rows=()):
    perm = np.stack([rng.permutation(A)[:K] for _ in range(G)])
    oh = np.zeros((G, K, A), bool)
    for g in range(G):
        oh[g, np.arange(K), perm[g]] = True
    for g, k in empty_rows:                 # a one-hot row that selects nothing
        oh[g, k] = False
    return oh


def fields(rng, G, A):
    ints = rng.integers(-127, 256, (G, A)).astype(np.int32)
    floats = (rng.standard_normal((G, A, 3)).astype(np.float32)
              * 10 ** rng.integers(-20, 20, (G, A, 3)).astype(np.float32))
    bools = rng.random((G, A)) > 0.5
    return ints, floats, bools


def packed(mod, conv, ints, floats, bools):
    pk = mod.Packer()
    pk.add_int(conv(ints))
    pk.add_f32(conv(floats))
    pk.add_int(conv(bools))
    pk.add_bf16(conv(floats[..., 0]))
    return pk


@pytest.mark.parametrize("empty_rows", [(), ((0, 2), (3, 6))])
def test_packer_gather_and_scatter_bit_equal(empty_rows):
    rng = np.random.default_rng(1)
    G, K, A = 5, 7, 16
    oh = permutation_one_hot(rng, G, K, A, empty_rows)
    data = fields(rng, G, A)
    jpk = packed(jpack, jnp.asarray, *data)
    tpk = packed(pack, torch.from_numpy, *data)
    np.testing.assert_array_equal(bits(tpk.payload()), bits(jpk.payload()))
    jout = jpk.unpack(jpack.gather_rows(jnp.asarray(oh), jpk.payload()))
    tout = tpk.unpack(pack.gather_rows(torch.from_numpy(oh), tpk.payload()))
    for i, (j, t) in enumerate(zip(jout, tout)):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape, i
        np.testing.assert_array_equal(bits(t), bits(j), err_msg=f"field {i}")
    for g, k in empty_rows:
        assert all(float(t[g, k].abs().sum()) == 0 for t in tout)

    jspk, tspk = jpack.Packer(), pack.Packer()
    jspk.add_f32(jout[1])
    tspk.add_f32(tout[1])
    jback = jspk.unpack(jpack.scatter_rows(jnp.asarray(oh), jspk.payload()))[0]
    tback = tspk.unpack(pack.scatter_rows(torch.from_numpy(oh), tspk.payload()))[0]
    np.testing.assert_array_equal(bits(tback), bits(jback))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8])
@pytest.mark.parametrize("density", [0.2, 0.6, 0.9])
def test_taa_round_trip_bit_equal(dtype, density):
    rng = np.random.default_rng(2)
    G, Asub, rows, C = 9, 16, 5, 3
    mask = rng.random((G, Asub)) > density
    payload = (rng.standard_normal((G, Asub, C)) * 100).astype(dtype)
    jslot, jvalid, _ = jpack.compact_slots(jnp.asarray(mask), rows)
    slot, valid, _ = pack.compact_slots(torch.from_numpy(mask), rows)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    jg = jpack.taa_gather(jnp.asarray(payload), jslot)
    g = pack.taa_gather(torch.from_numpy(payload), slot)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    jback = jpack.taa_scatter(jg, jslot, jvalid, Asub)
    back = pack.taa_scatter(g, slot, valid, Asub)
    assert back.dtype == g.dtype
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


def test_taa_scatter_empty_group_no_slot0_collision():
    """tests/test_pack.py's last case: a group with no set row scatters to
    zeros, and a group with one keeps only its slot."""
    mask = np.array([[False] * 8, [True] + [False] * 7])
    payload = np.arange(2 * 8 * 2, dtype=np.float32).reshape(2, 8, 2) + 1.0
    jslot, jvalid, _ = jpack.compact_slots(jnp.asarray(mask), 3)
    jback = np.asarray(jpack.taa_scatter(jpack.taa_gather(jnp.asarray(payload), jslot),
                                         jslot, jvalid, 8))
    slot, valid, _ = pack.compact_slots(torch.from_numpy(mask), 3)
    back = pack.taa_scatter(pack.taa_gather(torch.from_numpy(payload), slot), slot, valid, 8)
    np.testing.assert_array_equal(back.numpy(), jback)
    assert (back[0] == 0).all() and (back[1, 1:] == 0).all()
    np.testing.assert_array_equal(back[1, 0].numpy(), payload[1, 0])
