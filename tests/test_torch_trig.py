"""The port's glibc sinf/cosf reproduction is bit-exact against jnp.sin /
jnp.cos on XLA:CPU (which calls glibc), and its f32 fused multiply-add is
correctly rounded."""

from fractions import Fraction

import jax
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


def test_sincos_one_reduction_bit_exact():
    """sincos (one shared range reduction, as csrc/trig.cuh::sincosf_glibc)
    against trig.cos / trig.sin and the jitted jnp.cos / jnp.sin, on every
    branch: +-0, |y| < 2^-12, the unreduced range, multiples of pi/2 and
    their neighbours, negatives, and |y| >= 120 (reduce_large)."""
    rng = np.random.default_rng(3)
    k = np.arange(-300, 301)
    half_pi = (k * (np.pi / 2)).astype(np.float32)
    x = np.concatenate([
        np.array([0.0, -0.0, 2.0 ** -13, -(2.0 ** -13), 1e-30, -1e-30], np.float32),
        rng.uniform(-2.0 ** -12, 2.0 ** -12, 2000).astype(np.float32),
        rng.uniform(-0.8, 0.8, 20_000).astype(np.float32),
        half_pi, np.nextafter(half_pi, np.float32(np.inf)),
        np.nextafter(half_pi, np.float32(-np.inf)),
        rng.uniform(-120.0, 120.0, 100_000).astype(np.float32),
        (rng.uniform(120.0, 1e6, 50_000) * rng.choice([-1.0, 1.0], 50_000)).astype(np.float32),
        np.array([120.0, -120.0, 3e38, -3e38, np.inf, -np.inf, np.nan], np.float32),
    ])
    t = torch.from_numpy(x)
    c, s = trig.sincos(t)
    assert c.dtype == s.dtype == torch.float32 and c.shape == s.shape == t.shape
    for name, got, alone in (("cos", c, trig.cos(t)), ("sin", s, trig.sin(t))):
        want = np.asarray(jax.jit(getattr(jnp, name))(x))
        np.testing.assert_array_equal(got.numpy().view(np.int32), alone.numpy().view(np.int32))
        finite = np.isfinite(x)
        bad = np.nonzero(want[finite].view(np.int32) != got.numpy()[finite].view(np.int32))[0]
        assert bad.size == 0, (name, x[finite][bad[:5]])
        assert np.isnan(got.numpy()[~finite]).all() and np.isnan(want[~finite]).all()


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
