"""The threefry kernel (`csrc/threefry.cu` through `ops/threefry_cuda.py`)
against the plain int64 threefry (`rng.py`'s `*_reference` functions and
`use_kernels=False`), bit for bit, on the card.

Every test skips without a CUDA device; this file imports no JAX, so run it
on the card with `python -m pytest --noconftest tests/test_torch_rng_kernel.py`
(the CPU cases of the routing and the counters are in tests/test_torch_rng.py).
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.ops import threefry_cuda
from madrona_bots_tpu_torch.utils import profiling

SEEDS = (0, 7, 2**31 + 5, 2**62 + 3)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def keys(dev, lead=(), seed=1):
    """Keys [*lead, 2] folded from `rng.key(seed)`."""
    n = 1
    for d in lead:
        n *= d
    k = rng.fold_in_reference(rng.key(seed, dev)[None], torch.arange(n, device=dev)[:, None])
    return k.reshape(tuple(lead) + (2,))


def assert_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.contiguous().reshape(-1).view(torch.uint8),
                       want.contiguous().reshape(-1).view(torch.uint8))


def device_ops(fn) -> int:
    """Device operations one call of `fn` runs (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in p.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_split(dev, seed):
    k = rng.key(seed, dev)
    cases = [(k, 3), (k, 2**32 + 9), (k, torch.arange(5, device=dev)),
             (k, torch.tensor(2**31 - 1, dtype=torch.int32, device=dev)),
             (keys(dev, (6,), seed), 11),
             (keys(dev, (6,), seed), torch.arange(6, dtype=torch.int32, device=dev)),
             (keys(dev, (3, 1), seed), torch.arange(4, device=dev) * 977),
             (keys(dev, (4, 3), seed).transpose(0, 1), torch.tensor(-5, device=dev))]
    for key, data in cases:
        assert_bits(rng.fold_in(key, data), rng.fold_in_reference(key, data))
    for key in (k, keys(dev, (3,), seed)):
        for num in (2, 4, 7):
            assert_bits(rng.split(key, num), rng.split(key, num, use_kernels=False))


def test_threefry2x32_operands(dev):
    k = keys(dev, (5,))
    k0, k1 = k[:, 0], k[:, 1]
    x0 = torch.arange(5, device=dev)[:, None] * 2**28
    x1 = torch.arange(7, device=dev) + 2**32 - 3
    for args in ((k0, k1, 0, 0), (k0, k1, 0, 1), (k0[:, None], k1[:, None], x0, x1),
                 (k0[:1], 3, 2**32 - 1, x1)):
        got = rng.threefry2x32(*args)
        want = rng.threefry2x32_reference(*args)
        for g, w in zip(got, want):
            assert_bits(g, w.expand(g.shape))


@pytest.mark.parametrize("lead", [(), (4,)])
@pytest.mark.parametrize("offset", [0, 7, 65536 * 6, 2**32 - 3])
def test_random_bits_uniform_randint(dev, lead, offset):
    k = keys(dev, lead, seed=offset + 1)
    for shape in ((), (5,), (3, 300)):
        assert_bits(rng.random_bits(k, shape, offset),
                    rng.random_bits_reference(k, shape, offset))
        assert_bits(rng.uniform(k, shape, offset=offset),
                    rng.uniform(k, shape, offset=offset, use_kernels=False))
    b = torch.tensor(0.125, device=dev)
    assert_bits(rng.uniform(k, (69, 128), -b, b), rng.uniform(k, (69, 128), -b, b,
                                                              use_kernels=False))
    assert_bits(rng.gumbel(k, (1000,), offset), rng.gumbel(k, (1000,), offset,
                                                           use_kernels=False))
    for lo, hi in ((0, 10), (-5, 70000), (0, 2**31 - 1),
                   (0, torch.tensor([8, 6, 16, 16], device=dev))):
        assert_bits(rng.randint(k, (4,), lo, hi), rng.randint(k, (4,), lo, hi,
                                                              use_kernels=False))


@pytest.mark.parametrize("lead", [(), (4,)])
@pytest.mark.parametrize("rows", [1, 257, 65536])
@pytest.mark.parametrize("n", [2, 6, 7])
def test_categorical(dev, lead, rows, n):
    gen = torch.Generator(device=dev)
    gen.manual_seed(rows * 10 + n)
    logits = torch.randn(lead + (rows, n), generator=gen, device=dev) * 3
    k = keys(dev, lead, seed=rows + n)
    for offset in (0, 12345 * n, 2**32 - 5):
        got = rng.categorical(k, logits, offset)
        assert_bits(got, rng.categorical_reference(k, logits, offset))
    # a rank's rows of a global draw are the global draw's rows
    if rows > 1:
        r0 = rows // 3
        assert_bits(rng.categorical(k, logits[..., r0:, :], r0 * n),
                    rng.categorical(k, logits)[..., r0:])
    # logits of more dims and not contiguous
    wide = logits.reshape(lead + (1, rows, n)).transpose(-2, -3)
    assert_bits(rng.categorical(k, wide), rng.categorical_reference(k, wide))


def test_categorical_ties_infinities_and_nans(dev):
    inf, nan = float("inf"), float("nan")
    rows = [[0.0] * 6, [1e30, 0, 1e30, 0, 0, 0], [-inf] * 6, [inf] * 6,
            [-inf, inf, 0, inf, 0, 0], [0, nan, 0, nan, 0, 0], [nan] * 6,
            [inf, nan, -inf, 0, 0, 0], [-inf, -inf, -inf, -inf, -inf, 0],
            [3e38, 3e38, 3e38, -3e38, 0, 0], [0, 0, 0, 0, 0, -inf]]
    logits = torch.tensor(rows, device=dev).repeat(300, 1)
    for lead in ((), (3,)):
        k = keys(dev, lead, seed=11)
        x = logits.expand(lead + logits.shape)
        got = rng.categorical(k, x)
        assert_bits(got, rng.categorical_reference(k, x))
        assert bool((got.reshape(-1, len(rows))[:, 1] == 0).all())   # 1e30 ties: the first
        assert bool((got.reshape(-1, len(rows))[:, 5] == 1).all())   # the first NaN


def test_gumbel_transform_on_every_mantissa(dev):
    """All 2^23 values of `word >> 9`, with the low 9 bits set at random:
    the kernel's noise equals torch's transform of the same words."""
    words = torch.arange(1 << 23, dtype=torch.int64, device=dev) << 9
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    words |= torch.randint(0, 512, words.shape, generator=gen, device=dev)
    assert_bits(threefry_cuda.gumbel(words), rng._gumbel(words))


def test_categorical_replayed_from_a_graph(dev):
    """A captured draw reads its key and logits buffers at each replay: with
    new contents it equals the eager draw of them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    logits = torch.randn(4, 65536, 6, generator=gen, device=dev)
    key = keys(dev, (), seed=1).clone()
    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s):
        for _ in range(2):
            rng.categorical(rng.fold_in(key, torch.arange(4, device=dev)), logits)
    torch.cuda.current_stream(dev).wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = rng.categorical(rng.fold_in(key, torch.arange(4, device=dev)), logits)
    for seed in (9, 10, 2**40):
        key.copy_(rng.key(seed, dev))
        logits.copy_(torch.randn(logits.shape, generator=gen, device=dev))
        g.replay()
        want = rng.categorical(rng.fold_in(key, torch.arange(4, device=dev)), logits)
        assert_bits(out, want)
        assert_bits(out, rng.categorical_reference(
            rng.fold_in_reference(key, torch.arange(4, device=dev)), logits))


def test_launches_and_counters(dev):
    """A fold_in or split of a [2] key is at most 2 device operations, a
    draw over contiguous f32 logits 1; each call counts one kernel call."""
    k = rng.key(4, dev)
    logits = torch.randn(65536, 6, device=dev)
    assert device_ops(lambda: rng.fold_in(k, 3)) <= 2
    assert device_ops(lambda: rng.split(k, 2)) <= 2
    assert device_ops(lambda: rng.categorical(k, logits)) == 1
    profiling.reset_counts()
    launches = threefry_cuda.launches
    rng.categorical(rng.fold_in(k, 1), logits)
    rng.random_bits(k, (3,))
    assert threefry_cuda.launches - launches == 3
    assert profiling.counts() == {"rng_kernel_calls": 3}
    rng.categorical(rng.fold_in(k, 1, use_kernels=False), logits, use_kernels=False)
    assert profiling.counts() == {"rng_kernel_calls": 3, "rng_plain_calls": 2}
    assert threefry_cuda.launches - launches == 3


@pytest.mark.parametrize("call", ["f64 logits", "bf16 logits", "logits on the CPU",
                                  "keys on the CPU", "keys that do not broadcast",
                                  "data on the CPU"])
def test_calls_on_the_card_the_kernel_cannot_take_raise(dev, call):
    """A call on the card launches the kernel or raises: it never runs the
    plain version."""
    k, logits = keys(dev, (4,)), torch.randn(4, 33, 6, device=dev)
    fn = {"f64 logits": lambda: rng.categorical(k, logits.double()),
          "bf16 logits": lambda: rng.categorical(k, logits.bfloat16()),
          "logits on the CPU": lambda: rng.categorical(k, logits.cpu()),
          "keys on the CPU": lambda: rng.categorical(k.cpu(), logits),
          "keys that do not broadcast": lambda: rng.categorical(keys(dev, (3,)), logits),
          "data on the CPU": lambda: rng.fold_in(k, torch.arange(4))}[call]
    profiling.reset_counts()
    launches = threefry_cuda.launches
    with pytest.raises((ValueError, RuntimeError)):
        fn()
    assert threefry_cuda.launches == launches
    assert "rng_plain_calls" not in profiling.counts()


def test_categorical_broadcasts_keys_to_the_logits(dev):
    """Keys [1, 2] over logits [4, R, n] draw what the plain version draws:
    each of the four slices with the one key."""
    k, logits = keys(dev, (1,), seed=8), torch.randn(4, 257, 6, device=dev)
    assert_bits(rng.categorical(k, logits, 6), rng.categorical_reference(k, logits, 6))


def test_a_launch_imports_no_symbolic_shapes(dev):
    """The wrappers broadcast without `torch.broadcast_shapes`, whose first
    call imports sympy (~6 s of a process's set-up on the card's host)."""
    import subprocess
    import sys

    code = ("import sys, torch\n"
            "from madrona_bots_tpu_torch import rng\n"
            "k = rng.key(3, 'cuda')\n"
            "rng.categorical(rng.fold_in(k, torch.arange(4, device='cuda')),\n"
            "                torch.zeros(4, 8, 6, device='cuda'))\n"
            "rng.uniform(rng.split(k)[0], (5,))\n"
            "torch.cuda.synchronize()\n"
            "assert 'sympy' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
