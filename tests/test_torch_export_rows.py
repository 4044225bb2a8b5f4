"""The SimManager's export-row kernel (`ops/export_rows_cuda.py`,
`csrc/export_rows.cu`) and the order it runs over
(`utils/native.compaction_order`).

On the CPU: the plain versions against per-field `index_select` and against
a zero fill plus an `index_put`, the wrapper's checks, and the SimManager's
exports against the state gathered at its permutation. One test, which
skips without a CUDA device, holds the kernel to the plain versions at the
benchmark cell's shape (2048 worlds x 128 slots, ~95 % of the slots alive)
and counts its launches; this file imports nothing of the JAX package, so
the card runs it alone: `python -m pytest --noconftest
tests/test_torch_export_rows.py::test_kernel_equals_plain_at_the_cell_shape`."""

import numpy as np
import pytest
import torch

from madrona_bots_tpu_torch.api import SimManager
from madrona_bots_tpu_torch.ops import export_rows_cuda as xr
from madrona_bots_tpu_torch.utils import native, profiling

CASES = ["random", "empty_world", "all_dead", "all_alive"]
DTYPES = [torch.uint8, torch.int8, torch.int32, torch.float32]
WIDTHS = [1, 2, 3, 4, 5, 7, 8, 12, 16, 31, 32]
NINE = ("depth", "semantic", "reward", "position", "health", "surrounding", "action",
        "stats", "hidden_state")


def _population(case, W=16, A=64, NS=4, seed=0):
    """tests/test_torch_native.py's four populations: (alive, species)."""
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
    return torch.from_numpy(alive), torch.from_numpy(species)


def _rows(dtype, rows, width, gen, device="cpu"):
    if dtype.is_floating_point:
        return torch.randn((rows, width), generator=gen).to(device)
    lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256) if dtype == torch.uint8 \
        else (-2**31, 2**31 - 1)
    return torch.randint(lo, hi, (rows, width), generator=gen, dtype=dtype).to(device)


def _bytes(t):
    return t.contiguous().view(torch.uint8).cpu().numpy().tobytes()


def _order(case, seed=1):
    alive, species = _population(case, seed=seed)
    order, starts = native.compaction_order(alive, species, 4)
    return order, int(starts[-1])


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("case", CASES)
def test_plain_gather_is_index_select_by_field(case, dtype):
    """Eleven widths of one dtype (and int32 into float32) in one call: the
    first n rows of each destination are index_select's bytes, the rows
    after them stay as they were."""
    order, n = _order(case)
    perm = order[:n]
    gen = torch.Generator().manual_seed(2)
    srcs = [_rows(dtype, order.numel(), d, gen) for d in WIDTHS]
    pairs = [(s, torch.full((order.numel(), s.shape[1]), 7, dtype=dtype)) for s in srcs]
    if dtype == torch.int32:
        pairs.append((srcs[-1], torch.full((n + 3, WIDTHS[-1]), 7.0)))
    xr.gather(perm, pairs)
    for src, dst in pairs:
        want = src.index_select(0, perm).to(dst.dtype)
        assert _bytes(dst[:n]) == _bytes(want), (src.dtype, dst.dtype, src.shape)
        assert (dst[n:] == 7).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("case", CASES)
def test_plain_scatter_is_zero_fill_and_index_put(case, dtype):
    """The write-back over the whole order into uninitialised fields: the
    same bytes as a zero fill and an index_put of the first n rows."""
    order, n = _order(case)
    gen = torch.Generator().manual_seed(3)
    srcs = [_rows(dtype, order.numel(), d, gen) for d in WIDTHS]
    dsts = [torch.full_like(s, 5) for s in srcs]
    xr.scatter(order, n, list(zip(srcs, dsts)))
    for src, dst in zip(srcs, dsts):
        want = torch.zeros_like(src)
        want[order[:n]] = src[:n]
        assert _bytes(dst) == _bytes(want), (dtype, src.shape)


@pytest.mark.parametrize("case", CASES)
def test_order_tail_is_the_dead_slots_from_one_sort(case, monkeypatch):
    alive, species = _population(case, seed=4)
    sorts = []
    sort = torch.sort
    monkeypatch.setattr(torch, "sort", lambda *a, **k: sorts.append(1) or sort(*a, **k))
    syncs = profiling.counts().get("host_syncs", 0)
    order, starts = native.compaction_order(alive, species, 4)
    assert len(sorts) == 1 and profiling.counts()["host_syncs"] == syncs + 1
    n = int(starts[-1])
    perm, want_starts = native.compaction(alive, species, 4)
    assert order.dtype == torch.int64 and order.numel() == alive.numel()
    assert torch.equal(order[:n], perm) and np.array_equal(starts, want_starts)
    assert torch.equal(order[n:], torch.nonzero(~alive.reshape(-1))[:, 0])
    assert torch.equal(order.sort().values, torch.arange(alive.numel()))


@pytest.mark.parametrize("row_bytes,addrs,want", [
    (64, (0, 512), 16), (24, (0, 0), 8), (32, (4, 0), 4), (32, (0, 8), 8), (6, (0, 0), 2),
    (4, (0, 2), 2), (3, (0, 0), 1), (32, (1, 0), 1)])
def test_access_bytes(row_bytes, addrs, want):
    assert xr.access_bytes(row_bytes, *addrs) == want


def _refusals():
    o = torch.arange(8)
    i32, f32 = torch.zeros((8, 2), dtype=torch.int32), torch.zeros((8, 2))
    return {
        "order_int32": lambda: xr.gather(o.int(), [(i32, i32.clone())]),
        "float_into_int": lambda: xr.gather(o, [(f32, i32.clone())]),
        "widths_differ": lambda: xr.gather(o, [(i32, torch.zeros((8, 3), dtype=torch.int32))]),
        "strided_source": lambda: xr.gather(o, [(torch.zeros((8, 4))[:, ::2], f32.clone())]),
        "scatter_rows_short": lambda: xr.scatter(o, 4, [(f32, torch.zeros((7, 2)))]),
        "seventeen_fields": lambda: xr.gather(o, [(f32, f32.clone())] * 17),
        "valid_past_order": lambda: xr.scatter(o, 9, [(torch.zeros((9, 2)), f32.clone())]),
    }


@pytest.mark.parametrize("what", list(_refusals()))
def test_wrapper_refuses_what_the_kernel_does_not_take(what):
    with pytest.raises(ValueError, match="export_rows"):
        _refusals()[what]()


def _want_exports(mgr, is_prev):
    """Each export of one tick, gathered field by field from the state at the
    manager's permutation with index_select."""
    s, p, perm = mgr.state, "prev_" if is_prev else "", mgr._perm

    def rows(f):
        return f.reshape((-1,) + tuple(f.shape[2:])).index_select(0, perm)

    sem = getattr(s, p + "sensor_semantic")
    health = rows(getattr(s, p + "health"))[:, None]
    return {"depth": rows(sem).view(torch.uint8) if mgr.quirk_compat
            else rows(getattr(s, p + "sensor_depth")),
            "semantic": rows(sem), "reward": rows(getattr(s, p + "reward"))[:, None],
            "position": rows(getattr(s, p + "pos")),
            "health": health.view(torch.float32) if mgr.quirk_compat else health.float(),
            "surrounding": rows(getattr(s, p + "surrounding")),
            "action": rows(getattr(s, p + "action")), "stats": rows(getattr(s, p + "stats")),
            "hidden_state": rows(getattr(s, p + "hidden"))}


def _assert_exports(mgr):
    for is_prev in (False, True):
        for name, want in _want_exports(mgr, is_prev).items():
            got = getattr(mgr, f"{name}_tensor")(is_prev).to_torch()
            assert got.dtype == want.dtype and got.shape == want.shape, (name, is_prev)
            assert _bytes(got) == _bytes(want), (name, is_prev)


@pytest.mark.parametrize("quirk", [False, True])
def test_manager_exports_are_the_state_at_its_permutation(quirk):
    """Every export of both ticks, byte for byte, after steps and a shift,
    with and without quirk_compat (semantic bytes as depth, health's int32
    bits as float32); a repeated getter returns the same tensor, and one
    held across a step keeps its values."""
    mgr = SimManager(0, 3, 17, 16, device="cpu", quirk_compat=quirk)
    for t in range(3):
        act = mgr.action_tensor().to_torch()
        act.zero_()
        act[:, t % 6] = 1
        mgr.hidden_state_tensor().to_torch().fill_(0.25 * t)
        mgr.step()
        _assert_exports(mgr)
        held = mgr.position_tensor().to_torch()
        assert held is mgr.position_tensor().to_torch()
        kept = held.clone()
        mgr.shift_observations()
        _assert_exports(mgr)
        assert torch.equal(held, kept)


def test_no_export_launches_on_the_cpu():
    mgr = SimManager(0, 3, 5, 16, device="cpu")
    profiling.reset_counts()
    launches = xr.launches
    for _ in range(2):
        mgr.action_tensor().to_torch()[:, 0] = 1
        mgr.step()
        _assert_exports(mgr)
        mgr.shift_observations()
    assert profiling.counts().get("export_launches", 0) == 0 and xr.launches == launches
    assert profiling.counts()["steps"] == 2


def _cell_call(mgr, gen):
    """One call of the benchmark cell's loop: one-hot actions into the
    action export, a step, the 12 getters, a shift."""
    act = mgr.action_tensor().to_torch()
    draws = torch.randint(0, 6, (act.shape[0],), generator=gen, device=act.device)
    act.copy_(torch.nn.functional.one_hot(draws, 6).to(torch.int32))
    mgr.step()
    out = [mgr.species_count_tensor(), mgr.done_tensor(), mgr.sensor_index_tensor()]
    out += [getattr(mgr, f"{n}_tensor")(False) for n in NINE]
    mgr.shift_observations()
    return out


@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_kernel_equals_plain_at_the_cell_shape():
    """At 2048 x 128 (the respawn floor keeps ~95 % of the slots alive):
    five launches a call of the cell's loop; the manager's exports of both
    ticks are the state at its permutation; the gather of the cell's seven
    exports (and of odd u8 widths at unaligned pointers, every access
    width) and the write-back of both buffers equal the plain versions in
    bytes."""
    dev = torch.device("cuda")
    mgr = SimManager(0, 2048, 3200017001, 128, device=dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    mgr.hidden_state_tensor().to_torch().normal_(generator=gen)
    _cell_call(mgr, gen)
    torch.cuda.synchronize()
    launches, counted = xr.launches, profiling.counts().get("export_launches", 0)
    for _ in range(3):
        _cell_call(mgr, gen)
    torch.cuda.synchronize()
    assert xr.launches - launches == 15
    assert profiling.counts()["export_launches"] - counted == 15
    mgr.action_tensor().to_torch()[:, 1] = 1
    mgr.step()
    n, W, A = mgr.total_num_agents, 2048, 128
    assert 0.9 * W * A < n <= W * A
    _assert_exports(mgr)

    s, perm, rows = mgr.state, mgr._perm, W * A
    srcs = [s.sensor_depth, s.sensor_semantic, s.reward, s.pos, s.health, s.surrounding,
            s.stats, s.health]
    srcs = [f.reshape(rows, -1) for f in srcs]
    dtypes = [f.dtype for f in srcs[:-1]] + [torch.float32]
    flat = torch.randint(0, 256, (rows * 40,), dtype=torch.uint8, device=dev, generator=gen)
    for i, d in enumerate((1, 2, 3, 5, 8, 12, 16, 24)):
        off = (1, 2, 4, 8, 0, 3, 16, 1)[i]
        srcs.append(flat[off: off + rows * d].view(rows, d))
        dtypes.append(torch.uint8)
    got = [torch.empty((n, f.shape[1]), dtype=t, device=dev) for f, t in zip(srcs, dtypes)]
    want = [torch.empty_like(g) for g in got]
    xr.gather(perm, list(zip(srcs, got)))
    xr.gather_reference(perm, list(zip(srcs, want)))
    widths = {xr.access_bytes(f.shape[1] * f.element_size(), f.data_ptr(), g.data_ptr())
              for f, g in zip(srcs, got)}
    assert widths == {1, 2, 4, 8, 16}
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert _bytes(g) == _bytes(w), i

    order = mgr._order
    bufs = [mgr._action_buf, mgr._hidden_buf]
    for valid in (n, n - 1000):
        got = [torch.full_like(b, 3) for b in bufs]
        want = [torch.full_like(b, 3) for b in bufs]
        xr.scatter(order, valid, list(zip(bufs, got)))
        xr.scatter_reference(order, valid, list(zip(bufs, want)))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert _bytes(g) == _bytes(w), valid
