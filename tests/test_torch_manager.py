"""The port's SimManager against the JAX SimManager (use_pallas=False), one
case per test of tests/test_manager.py: both start from the same
constructor arguments and take the same actions, each written through its
own package's buffer, and every exported tensor is compared after each
step. All getters are bit-equal but `surrounding`, which the port's state
holds to the JAX state within rtol 1e-5, atol 1e-4 (SPEC D10; the tolerance
of tests/test_torch_state.py)."""

import numpy as np
import pytest
import torch

from madrona_bots_tpu.api import SimManager as JaxManager
from madrona_bots_tpu_torch.api import SimManager, Tensor
from madrona_bots_tpu_torch.madrona_bots import SimManager as ShimManager

# Two world shapes a file (each new JAX config is a fresh jit): the
# reference's 4 worlds x 32 agents, and an odd world count.
FOUR = dict(num_worlds=4, init=32)
ODD = dict(num_worlds=3, init=16)


def make_pair(shape, seed, **kw):
    W, init = shape["num_worlds"], shape["init"]
    jm = JaxManager(0, W, seed, init, use_pallas=False, **kw)
    tm = SimManager(0, W, seed, init, device="cpu", **kw)
    return jm, tm


def getters(mgr) -> dict:
    """Every exported tensor of a manager (either package) as numpy."""
    out = {"species_count": mgr.species_count_tensor().to_numpy(),
           "done": mgr.done_tensor().to_numpy(),
           "sensor_index": mgr.sensor_index_tensor().to_numpy()}
    for prev in (False, True):
        for name in ("depth", "semantic", "reward", "position", "health",
                     "surrounding", "action", "stats", "hidden_state"):
            out[f"{name}_{prev}"] = getattr(mgr, f"{name}_tensor")(prev).to_numpy()
    return out


def assert_managers_equal(jm, tm, ctx=""):
    assert tm.total_num_agents == jm.total_num_agents, ctx
    np.testing.assert_array_equal(tm.species_offsets(), jm.species_offsets())
    assert tm.species_offsets().dtype == np.int32
    for w in range(jm.cfg.num_worlds):
        assert tm.agent_offset_for_world(w) == jm.agent_offset_for_world(w), (ctx, w)
    want, got = getters(jm), getters(tm)
    assert want.keys() == got.keys()
    for k in want:
        a, b = np.asarray(want[k]), got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, k, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        if k.startswith("surrounding"):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4, err_msg=f"{ctx} {k}")
        else:
            assert a.tobytes() == b.tobytes(), (ctx, k, int((a != b).sum()))


def random_one_hot(rng, n):
    a = np.zeros((n, 6), np.int32)
    a[np.arange(n), rng.integers(0, 6, n)] = 1
    a[:, 4] |= rng.integers(0, 2, n).astype(np.int32)       # shoot often
    return a


def write_actions(jm, tm, acts):
    """The same actions through each package's own exported buffer."""
    jm.action_tensor(False).to_numpy()[:] = acts
    tm.action_tensor(False).to_torch()[:] = torch.from_numpy(acts)


@pytest.mark.parametrize("quirk", [False, True])
def test_manager_basic_flow(quirk):
    """4 steps of random actions (and hidden writes), every getter after
    each; with quirk_compat the depth (semantic bytes, negatives included)
    and health (int32 bits as f32) quirks."""
    jm, tm = make_pair(FOUR, 42, quirk_compat=quirk)
    assert tm.total_num_agents == 4 * 32
    assert_managers_equal(jm, tm, "init")
    rng = np.random.default_rng(0)
    for t in range(4):
        n = tm.total_num_agents
        write_actions(jm, tm, random_one_hot(rng, n))
        mem = rng.standard_normal((n, jm.cfg.hidden_state_dim)).astype(np.float32)
        jm.hidden_state_tensor(False).to_numpy()[:] = mem
        tm.hidden_state_tensor(False).to_torch()[:] = torch.from_numpy(mem)
        jm.step()
        tm.step()
        assert_managers_equal(jm, tm, f"step {t}")
        if t % 2:
            jm.shift_observations()
            tm.shift_observations()
            assert_managers_equal(jm, tm, f"shift {t}")
    sp_rows = tm.state.species.reshape(-1)[tm._perm].numpy()
    assert (np.diff(sp_rows) >= 0).all()
    sem = tm.semantic_tensor(False).to_numpy()
    if quirk:
        assert (sem < 0).any()
        np.testing.assert_array_equal(tm.depth_tensor(False).to_numpy(), sem.view(np.uint8))
        h = tm.state.health.reshape(-1)[tm._perm].numpy().astype(np.int32)
        np.testing.assert_array_equal(tm.health_tensor(False).to_numpy()[:, 0],
                                      h.view(np.float32))


def test_action_write_back_roundtrip():
    """Everyone forward and hidden 0.5, written once; the step applies them
    and the hidden state survives, in both packages alike."""
    jm, tm = make_pair(ODD, 7)
    jm.step()
    tm.step()
    n = tm.total_num_agents
    acts = np.zeros((n, 6), np.int32)
    acts[:, 0] = 1
    write_actions(jm, tm, acts)
    jm.hidden_state_tensor(False).to_numpy()[:] = 0.5
    tm.hidden_state_tensor(False).to_torch().fill_(0.5)
    pos_before = tm.position_tensor(False).to_numpy().copy()
    perm_before = tm._perm.clone()
    jm.step()
    tm.step()
    assert_managers_equal(jm, tm, "after write-back")
    alive = tm.state.alive.reshape(-1)[perm_before]
    moved = (tm.state.pos.reshape(-1, 2)[perm_before].numpy() != pos_before).any(1)
    assert moved[alive.numpy()].sum() > n // 2
    kept = (tm.state.hidden.reshape(-1, 16)[perm_before][alive] == 0.5).all(1)
    assert kept.float().mean() > 0.5


def test_shift_observations_via_manager():
    jm, tm = make_pair(ODD, 3)
    for m in (jm, tm):
        m.step()
    health = tm.health_tensor(False).to_numpy().copy()
    for m in (jm, tm):
        m.shift_observations()
    np.testing.assert_array_equal(tm.health_tensor(True).to_numpy(), health)
    assert_managers_equal(jm, tm, "shift")


def test_sensor_index_tensor():
    jm, tm = make_pair(ODD, 5)
    for m in (jm, tm):
        m.step()
    idx = tm.sensor_index_tensor().to_numpy()
    n = tm.total_num_agents
    assert idx.shape == (n, 1) and idx.dtype == np.int32
    assert sorted(idx[:, 0].tolist()) == list(range(n))
    assert tm.agent_offset_for_world(0) == 0
    assert 0 < tm.agent_offset_for_world(1) <= n
    assert_managers_equal(jm, tm, "sensor index")


def test_set_action_and_quirk_depth():
    """set_action by exported row reaches the simulator as in the JAX
    manager; quirk_compat depth is the semantic bytes."""
    jm, tm = make_pair(ODD, 1, quirk_compat=True)
    for m in (jm, tm):
        m.step()
    for row in (0, tm.total_num_agents // 2, tm.total_num_agents - 1):
        for m in (jm, tm):
            m.set_action(row, forward=1, backward=0, rotate_left=1, rotate_right=0,
                         shoot=1, breed=0)
    np.testing.assert_array_equal(tm.action_tensor(False).to_numpy()[0], [1, 0, 1, 0, 1, 0])
    for m in (jm, tm):
        m.step()
    assert_managers_equal(jm, tm, "set_action")
    d, s = tm.depth_tensor(False).to_numpy(), tm.semantic_tensor(False).to_numpy()
    np.testing.assert_array_equal(d, s.astype(np.uint8))


def test_held_action_buffer_stays_live():
    """A tensor fetched once stays live across step(): writes made into it
    after a step still reach the simulator."""
    jm, tm = make_pair(ODD, 3)
    jbuf = jm.action_tensor(False).to_numpy()
    tbuf = tm.action_tensor(False).to_torch()
    for m in (jm, tm):
        m.step()
    for buf in (jbuf, tbuf):
        buf[:] = 0
        buf[:, 2] = 1                                    # everyone rotates left
    h0 = tm.state.heading.clone()
    for m in (jm, tm):
        m.step()
    alive = tm.state.alive
    assert ((tm.state.heading - h0).abs() > 1e-6)[alive].any(), "held writes dropped"
    assert_managers_equal(jm, tm, "held buffer")


def test_odd_worlds_steps():
    """Three worlds (an odd count: the JAX package's blocked raycast shape)
    over 4 steps with shifts."""
    jm, tm = make_pair(ODD, 11)
    rng = np.random.default_rng(11)
    for t in range(4):
        write_actions(jm, tm, random_one_hot(rng, tm.total_num_agents))
        for m in (jm, tm):
            m.step()
            m.shift_observations()
        assert_managers_equal(jm, tm, f"step {t}")


def test_exports_are_the_managers_tensors():
    """to_torch() is the manager's own tensor; the shim exports the same
    class; without a card the default device raises."""
    tm = SimManager(0, 3, 0, 16, device="cpu")
    assert ShimManager is SimManager
    t = tm.position_tensor(False)
    assert isinstance(t, Tensor) and t.to_torch() is tm.position_tensor(False).to_torch()
    assert t.shape == (tm.total_num_agents, 2)
    assert np.asarray(t).dtype == np.float32
    if torch.cuda.is_available():
        assert SimManager(0, 3, 0, 16).state.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            SimManager(0, 4, 0, 32)
