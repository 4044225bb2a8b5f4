"""The port's glibc sinf/cosf reproduction is bit-exact against jnp.sin /
jnp.cos on XLA:CPU (which calls glibc), and its f32 fused multiply-add is
correctly rounded."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_bots_tpu_torch import trig


def _inputs():
    rng = np.random.default_rng(0)
    wide = rng.uniform(-200.0, 200.0, 1_000_000).astype(np.float32)
    headings = rng.uniform(-8.0, 8.0, 200_000).astype(np.float32)
    k = np.arange(-400, 401)
    quarter = (k * (np.pi / 4)).astype(np.float32)
    near_quarter = np.concatenate([np.nextafter(quarter, np.float32(np.inf)),
                                   np.nextafter(quarter, np.float32(-np.inf))])
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, 1.17e-38,
                        2.0 ** -12, -(2.0 ** -12), 0.75, -0.75, 120.0, -120.0,
                        119.99999, 1e4, -1e4, 3e38, -3e38], np.float32)
    return np.concatenate([wide, headings, quarter, near_quarter, special])


@pytest.mark.parametrize("name", ["cos", "sin"])
def test_trig_bit_exact_against_xla_cpu(name):
    x = _inputs()
    assert x.size >= 1_000_000
    want = np.asarray(getattr(jnp, name)(x))
    got = getattr(trig, name)(torch.from_numpy(x)).numpy()
    bad = np.nonzero(want.view(np.int32) != got.view(np.int32))[0]
    assert bad.size == 0, (f"{bad.size} mismatches, first x={x[bad[0]]!r}: "
                           f"jax={want[bad[0]]!r} port={got[bad[0]]!r}")


def test_fma_f32_correctly_rounded():
    rng = np.random.default_rng(1)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = (rng.standard_normal(3000) * 10.0 ** rng.integers(-8, 3, 3000)).astype(np.float32)
    got = trig.fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        err = abs(Fraction(float(g)) - exact)
        for nb in (np.nextafter(g, np.float32(np.inf)),
                   np.nextafter(g, np.float32(-np.inf))):
            assert err <= abs(Fraction(float(nb)) - exact), (x, y, z, g)
