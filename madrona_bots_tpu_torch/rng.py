"""Counter-based RNG: threefry2x32 as used by `jax.random`.

The env draws every random number from keys derived with `fold_in` (world
keys, initial positions, food spawns, respawn positions), so reproducing
jax's bits makes the port's trajectories equal to the JAX package's. This
module reproduces jax 0.9.0 with `jax_threefry_partitionable=True`:

* `fold_in(key, d)`     = threefry(key, (0, d))
* `random_bits(key, s)` = y0 ^ y1 of threefry(key, (0, i)) over the
  row-major flat index i of shape s
* `uniform` sets the 23 mantissa bits of a float in [1, 2) and subtracts 1
* `randint` draws two words per value from the split keys (0, 0) and (0, 1)
  and folds them into the span as jax's `_randint` does
* `split(key, n)[i]` = `fold_in(key, i)`; `categorical` is argmax(logits +
  Gumbel noise) as `jax.random.categorical` draws it (the learners' action
  sampling, one `fold_in(key, s)` per species; with a [NS, 2] key stack it
  draws all species at once, as the stacked learners' vmapped draw does)

Keys are `[..., 2]` int64 tensors holding uint32 words; all uint32
arithmetic runs in int64 with `& 0xFFFFFFFF`, so it works on any device and
the counters (for example the step count) may stay device tensors.
"""

from __future__ import annotations

import math

import torch

from madrona_bots_tpu_torch.trig import fma_f32

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x) -> torch.Tensor | int:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return int(x) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on broadcastable uint32-valued tensors."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.key(seed)` as raw data: [hi32(seed), lo32(seed)]."""
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`; `data` (int or tensor) broadcasts against the
    key's leading dims."""
    d = _u32(data)
    k0, k1 = key[..., 0], key[..., 1]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(k0), d + torch.zeros_like(k0))
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape, offset: int = 0) -> torch.Tensor:
    """32-bit words [*key.shape[:-1], *shape] (jax's partitionable bits).
    With `offset` the words are those of flat indices offset, offset + 1,
    ... of a larger draw: a shard's slice of the global draw."""
    shape = tuple(shape)
    n = math.prod(shape)
    ctr = torch.arange(offset, offset + n, dtype=torch.int64,
                       device=key.device).reshape(shape)
    tail = (None,) * len(shape)
    k0 = key[(..., 0) + tail]
    k1 = key[(..., 1) + tail]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
    return y0 ^ y1


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: [num, *key.shape]. With partitionable
    threefry the i-th key is threefry(key, (0, i)), i.e. `fold_in(key, i)`."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    return fold_in(key[None], idx.reshape((num,) + (1,) * (key.dim() - 1)))


def uniform(key: torch.Tensor, shape, minval=None, maxval=None,
            offset: int = 0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32[, minval, maxval])`; without
    bounds in [0, 1). With bounds the value is max(minval, fma(u, maxval -
    minval, minval)) in f32: XLA:CPU contracts jax's `u * span + minval`
    into one fused multiply-add. `offset` as in `random_bits`."""
    bits = random_bits(key, shape, offset)
    one_bits = (bits >> 9) | 0x3F800000
    u = one_bits.to(torch.int32).view(torch.float32) - 1.0
    if minval is None:
        return u
    lo = torch.as_tensor(minval, dtype=torch.float32, device=u.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=u.device)
    return torch.maximum(lo, fma_f32(u, (hi - lo).expand_as(u), lo.expand_as(u)))


_TINY = float(torch.finfo(torch.float32).tiny)


def gumbel(key: torch.Tensor, shape, offset: int = 0) -> torch.Tensor:
    """`jax.random.gumbel(key, shape, float32)` in its default "low" mode:
    -log(-log(uniform(key, minval=tiny, maxval=1))). The uniform's span
    1 - tiny rounds to 1, so the draw is u where u > 0 and tiny at u == 0.
    `offset` as in `random_bits`."""
    u = uniform(key, shape, offset=offset)
    return -torch.log(-torch.log(torch.clamp(u + _TINY, min=_TINY)))


def categorical(key: torch.Tensor, logits: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """`jax.random.categorical(key, logits, axis=-1)`: argmax(gumbel +
    logits) over the last axis, first index on ties; int64. Keys with
    leading axes [*K, 2] draw `jax.vmap(jax.random.categorical)` over
    logits [*K, ...]: each key its own slice, as one chain of launches.
    `offset` is the flat index, in each key's global draw, of the first
    element of these logits: a rank that holds rows [r0, r1) of a global
    [R, n] draw passes r0 * n and draws exactly its rows of it."""
    return torch.argmax(gumbel(key, logits.shape[key.dim() - 1:], offset) + logits, dim=-1)


def randint(key: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` as int32; the bounds
    broadcast against `shape`."""
    k0, k1 = key[..., 0], key[..., 1]
    zero = torch.zeros_like(k0)
    ka = torch.stack(threefry2x32(k0, k1, zero, zero), dim=-1)
    kb = torch.stack(threefry2x32(k0, k1, zero, zero + 1), dim=-1)
    higher = random_bits(ka, shape)
    lower = random_bits(kb, shape)
    lo, hi = minval, maxval                    # ints or int64 device tensors
    if isinstance(lo, int) and isinstance(hi, int):
        span = max(hi - lo, 1)
    else:
        span = torch.where(torch.as_tensor(hi <= lo), 1, (hi - lo) & MASK32)
    # uint32 arithmetic: products and sums wrap at 2^32, as in jax.
    mult = (((65536 % span) * (65536 % span)) & MASK32) % span
    offset = ((((higher % span) * mult) & MASK32) + lower % span) & MASK32
    return (lo + offset % span).to(torch.int32)
