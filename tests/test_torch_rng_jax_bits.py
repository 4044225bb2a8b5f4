"""The threefry kernel against `jax.random` itself, bit for bit, at the A2C
cell's shape: `fold_in`, `split`, `random_bits` with an offset and the
categorical draw over 65,536 x 6 logits, with [2] and [4, 2] keys.

The card has no JAX, so each case's output is held by the SHA-256 of its
bytes, as jax 0.9.0 (`jax_threefry_partitionable`) computes it on the CPU:
`test_jax_and_the_plain_version_give_these_bits` recomputes every digest
with jax, and with the port's plain int64 threefry, on the CPU;
`test_the_kernel_gives_jax_bits` holds the kernel on the card to the same
digests. The card test imports no JAX: run it there with
`python -m pytest --noconftest tests/test_torch_rng_jax_bits.py -k kernel`.
The inputs are built from integer arithmetic alone, so both machines
build the same logits.
"""

import hashlib

import numpy as np
import pytest
import torch

from madrona_bots_tpu_torch import rng

ROWS, WIDTH, SPECIES = 65536, 6, 4
R0 = 21845                 # a shard's first row: its draw starts at counter R0 * WIDTH


def logits(shape, salt: int) -> torch.Tensor:
    """f32 logits in [-4, 4) on a 2^-17 grid from an integer hash of the
    flat index: exact, so every machine builds the same values."""
    i = torch.arange(int(np.prod(shape)), dtype=torch.int64) + salt * 0x9E3779B9
    h = (i * 2654435761) & 0xFFFFFFFF
    h ^= h >> 15
    h = (h * 2246822519) & 0xFFFFFFFF
    h ^= h >> 13
    return ((h & 0xFFFFF).to(torch.float32) / 2**17 - 4.0).reshape(shape)


def species_keys(seed: int, dev=None) -> torch.Tensor:
    """The stacked tick's keys: `fold_in(key(seed), arange(4))`, [4, 2]."""
    return rng.fold_in_reference(rng.key(seed, dev), torch.arange(SPECIES, device=dev))


def port(case: str, dev, use_kernels: bool) -> torch.Tensor:
    """The port's output of a case on `dev`."""
    k = rng.key(3_200_022_000, dev)
    ks = species_keys(2**31 + 5, dev)
    kw = dict(use_kernels=use_kernels)
    if case == "fold_in":
        return torch.stack([rng.fold_in(k, d, **kw) for d in (0, 3, 2**31 - 1, 2**32 - 1)])
    if case == "fold_in_stacked":
        return rng.fold_in(rng.key(7, dev), torch.arange(SPECIES, device=dev), **kw)
    if case == "split":
        return torch.cat([rng.split(k, 2, **kw), rng.split(k, 4, **kw)])
    if case == "split_stacked":
        return rng.split(ks, 3, **kw)
    if case == "random_bits_offset":
        return rng.random_bits(k, (ROWS - R0, WIDTH), R0 * WIDTH, **kw)
    if case == "categorical":
        return rng.categorical(rng.fold_in(k, 2, **kw), logits((ROWS, WIDTH), 1).to(dev), **kw)
    if case == "categorical_stacked":
        return rng.categorical(ks, logits((SPECIES, ROWS, WIDTH), 2).to(dev), **kw)
    if case == "categorical_stacked_offset":
        x = logits((SPECIES, ROWS, WIDTH), 3)[:, R0:].to(dev)
        return rng.categorical(ks, x, R0 * WIDTH, **kw)
    raise KeyError(case)


def jax_bits(case: str) -> np.ndarray:
    """The same case computed by `jax.random` on the CPU."""
    import jax
    import jax.numpy as jnp

    data = jax.random.key_data
    k = jax.random.key(3_200_022_000)
    ks = jax.vmap(lambda s: jax.random.fold_in(jax.random.key(2**31 + 5), s))(
        jnp.arange(SPECIES))
    if case == "fold_in":
        return np.stack([np.asarray(data(jax.random.fold_in(k, np.uint32(d))))
                         for d in (0, 3, 2**31 - 1, 2**32 - 1)])
    if case == "fold_in_stacked":
        return np.asarray(data(jax.vmap(lambda s: jax.random.fold_in(jax.random.key(7), s))(
            jnp.arange(SPECIES))))
    if case == "split":
        return np.concatenate([np.asarray(data(jax.random.split(k, n))) for n in (2, 4)])
    if case == "split_stacked":
        return np.asarray(data(jax.vmap(lambda x: jax.random.split(x, 3))(ks))).swapaxes(0, 1)
    if case == "random_bits_offset":
        return np.asarray(jax.random.bits(k, (ROWS, WIDTH), jnp.uint32))[R0:]
    if case == "categorical":
        return np.asarray(jax.jit(jax.random.categorical)(
            jax.random.fold_in(k, 2), logits((ROWS, WIDTH), 1).numpy()))
    if case == "categorical_stacked":
        return np.asarray(jax.jit(jax.vmap(jax.random.categorical))(
            ks, logits((SPECIES, ROWS, WIDTH), 2).numpy()))
    if case == "categorical_stacked_offset":
        return np.asarray(jax.jit(jax.vmap(jax.random.categorical))(
            ks, logits((SPECIES, ROWS, WIDTH), 3).numpy()))[:, R0:]
    raise KeyError(case)


def digest(x) -> str:
    """SHA-256 of the values as little-endian int64, shape first."""
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x).astype("<i8")
    h = hashlib.sha256(repr(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


# jax 0.9.0's outputs on the CPU (`jax_bits`), by their digests.
JAX_DIGESTS = {
    "fold_in": "782df08e0ba913793e5c9222d4e15e34d7afb20ac0915a9a213fd37e602157ab",
    "fold_in_stacked": "507cf839498b8d3858c432bf09a5f08da26bb8b44e171bdf0d4b8f0fea0586ea",
    "split": "4f3696318253d3c5c267c7e7bcdc02fb280d000316851fe405779af2f2876c1c",
    "split_stacked": "240f5ece1919401e4a351f4a63b3ea1ddb1be48c423b8645de7d0ccca2ea47ac",
    "random_bits_offset": "9ec89c062e2ac696f808d2fe058a442d006633b2cbb0747d994fe6626b82a503",
    "categorical": "e9d78127aa290db298b61b2a59e5fc13ec3f1da699338e453015a546623de4a3",
    "categorical_stacked": "e7e6a8ac5b511dc8a18eaa8a8e4d79e1ed104b2a6aed84fda8872d5593b20b50",
    "categorical_stacked_offset":
        "ea8733ccdd8296454af46469ae996a9f7d5076db713e6515196991fed610168c",
}


@pytest.mark.parametrize("case", sorted(JAX_DIGESTS))
def test_jax_and_the_plain_version_give_these_bits(case):
    """On the CPU: jax gives the recorded bits, and so does the port's plain
    threefry (CPU tensors take it)."""
    pytest.importorskip("jax")
    assert digest(jax_bits(case)) == JAX_DIGESTS[case]
    assert digest(port(case, "cpu", use_kernels=True)) == JAX_DIGESTS[case]


@pytest.mark.parametrize("case", sorted(JAX_DIGESTS))
def test_the_kernel_gives_jax_bits(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from madrona_bots_tpu_torch.ops import threefry_cuda
    from madrona_bots_tpu_torch.utils import profiling

    profiling.reset_counts()
    launches = threefry_cuda.launches
    got = port(case, torch.device("cuda"), use_kernels=True)
    assert threefry_cuda.launches > launches
    assert "rng_plain_calls" not in profiling.counts()
    assert digest(got) == JAX_DIGESTS[case]
