"""The port's export data plane (`utils/native.py`, torch on the state's
device) against the JAX package's (`madrona_bots_tpu/utils/native.py`, the
host library or its numpy version): equal integers and bytes."""

import numpy as np
import pytest
import torch

from madrona_bots_tpu.utils import native as jnative
from madrona_bots_tpu_torch.utils import native


def _population(case, W=16, A=64, NS=4, seed=0):
    rng = np.random.default_rng(seed)
    if case == "random":
        alive = rng.random((W, A)) < 0.7
    elif case == "empty_world":
        alive = rng.random((W, A)) < 0.5
        alive[3] = False
    elif case == "all_dead":
        alive = np.zeros((W, A), bool)
    else:                                                   # all_alive
        alive = np.ones((W, A), bool)
    species = np.where(alive, rng.integers(1, NS + 1, (W, A)), 0).astype(np.int32)
    return alive, species


CASES = ["random", "empty_world", "all_dead", "all_alive"]


@pytest.mark.parametrize("case", CASES)
def test_compaction_and_offsets(case):
    alive, species = _population(case)
    want_perm, want_starts = jnative.compaction(alive, species, 4)
    perm, starts = native.compaction(torch.from_numpy(alive), torch.from_numpy(species), 4)
    assert isinstance(starts, np.ndarray) and starts.dtype == np.int32
    np.testing.assert_array_equal(starts, want_starts)
    np.testing.assert_array_equal(perm.numpy(), want_perm)
    want_off, want_cnt = jnative.world_offsets(alive)
    off, cnt = native.world_offsets(torch.from_numpy(alive))
    np.testing.assert_array_equal(off.numpy(), want_off)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    np.testing.assert_array_equal(native.inverse_perm(perm, alive.size).numpy(),
                                  jnative.inverse_perm(want_perm, alive.size))


@pytest.mark.parametrize("case", CASES)
def test_gather_and_scatter_rows(case):
    alive, species = _population(case, seed=1)
    perm, _ = jnative.compaction(alive, species, 4)
    tperm = torch.from_numpy(perm.astype(np.int64))
    rng = np.random.default_rng(2)
    for src in (rng.integers(0, 256, (alive.size, 32), dtype=np.uint8),
                rng.integers(-5, 5, (alive.size, 6), dtype=np.int32),
                rng.standard_normal((alive.size, 16)).astype(np.float32)):
        got = native.gather_rows(torch.from_numpy(src), tperm).numpy()
        want = jnative.gather_rows(src, perm)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        rows = want
        dst_j = np.zeros_like(src)
        if perm.size:       # the JAX host library cannot reshape zero rows
            jnative.scatter_rows(rows, perm, dst_j)
        dst_t = torch.zeros(src.shape, dtype=torch.from_numpy(src).dtype)
        native.scatter_rows(torch.from_numpy(rows), tperm, dst_t)
        assert dst_t.numpy().tobytes() == dst_j.tobytes()


def test_scatter_rows_into_strided_destination():
    """A non-contiguous destination (every other column of a wider buffer)
    takes the rows in place."""
    alive, species = _population("random", seed=3)
    perm, _ = jnative.compaction(alive, species, 4)
    rows = np.random.default_rng(4).standard_normal((perm.size, 6)).astype(np.float32)
    wide_j = np.zeros((alive.size, 12), np.float32)
    jnative.scatter_rows(rows, perm, wide_j[:, ::2])
    wide_t = torch.zeros((alive.size, 12))
    dst = wide_t[:, ::2]
    assert not dst.is_contiguous()
    native.scatter_rows(torch.from_numpy(rows), torch.from_numpy(perm.astype(np.int64)), dst)
    assert wide_t.numpy().tobytes() == wide_j.tobytes()
