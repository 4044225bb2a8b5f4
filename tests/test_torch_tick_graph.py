"""The CLI's A2C loop body as one CUDA graph (`learn/tick_graph.py`).

On the CPU: `training_loop.run_tick` stays eager (no graph is called, no
graph counter counts, the result is the eager body's); only the A2C tick
without a mesh carries a graph; the flat buffer's views rebuild the train
states and train like them; the benchmark's reader of the replays.

On the card (skips without one; this file imports no JAX, run it with
`python -m pytest --noconftest tests/test_torch_tick_graph.py`): at the
benchmark cell's 2048 worlds and four nets, the graphed loop against the
eager one from equal inputs, in every A2C mode the CLI runs.
"""

import pytest
import torch

from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.config import EnvConfig, RewardSetting
from madrona_bots_tpu_torch.env.state import FIELDS, init_state
from madrona_bots_tpu_torch.learn import a2c, ppo, tick_graph, training_loop
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator
from madrona_bots_tpu_torch.utils import profiling
from portbench import core

CONFIG = core.data("configs", "upstream-a2c-w2048")
LIMITS = core.data("workloads", "upstream-a2c-w2048.train")["check"]["limits"]


def small_loop(stacked=False, seed=3):
    """A tiny A2C loop on the CPU: (tick, state, train states, key)."""
    cfg = EnvConfig(num_worlds=2)
    gen = SpeciesNetGenerator(69, 6, 32, 16, seed=seed)
    models = [ActorCritic(gen.sample_config()) for _ in range(4)]
    tick, opt = a2c.make_train_tick(models, cfg, stacked=stacked,
                                    learner_slots_per_class=12 if stacked else None)
    k = rng.key(seed)
    ts = (a2c.init_stacked_train_state(models, k, opt) if stacked
          else a2c.init_train_states(models, k, opt))
    return tick, init_state(cfg, seed, "cpu"), ts, rng.key(seed + 1)


def test_cpu_loop_is_the_eager_body(monkeypatch):
    """On a CPU state run_tick never calls the tick's graph, counts no graph
    counter, and returns what the eager body (split, tick, stack) gives."""
    def refuse(*args):
        raise AssertionError("a CPU state reached the tick's graph")
    monkeypatch.setattr(tick_graph.TickGraph, "__call__", refuse)
    tick, state, ts, key = small_loop()
    want_state, want_ts, want_key = state.clone(), ts, key
    profiling.reset_counts()
    for _ in range(2):
        state, ts, key, metrics = training_loop.run_tick(tick, state, ts, key)
        sub = rng.split(want_key, 2)
        want_key = sub[0]
        want_state, want_ts, m = tick(want_state, want_ts, sub[1])
        assert list(metrics) == list(m)
        assert list(metrics.values()) == a2c.stack_metrics(m).tolist()
    assert not [k for k in profiling.counts() if k.startswith("tick_graph")]
    assert torch.equal(key, want_key)
    for f in FIELDS:
        assert torch.equal(getattr(state, f), getattr(want_state, f)), f
    for a, b in zip(tick_graph.leaves(ts), tick_graph.leaves(want_ts)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["a2c", "a2c_stacked", "a2c_mesh", "ppo"])
def test_only_the_meshless_a2c_tick_carries_a_graph(kind):
    """PPO's iteration and a mesh's A2C tick (its collectives) stay eager.
    The mesh is a stand-in: building the A2C tick does not touch it."""
    cfg = EnvConfig(num_worlds=2)
    gen = SpeciesNetGenerator(69, 6, 32, 16, seed=0)
    models = [ActorCritic(gen.sample_config()) for _ in range(4)]
    mesh = object() if kind == "a2c_mesh" else None
    if kind == "ppo":
        tick, _ = ppo.make_ppo_trainer(models, cfg)
    else:
        tick, _ = a2c.make_train_tick(models, cfg, mesh=mesh, stacked=kind == "a2c_stacked",
                                      learner_slots_per_class=12)
    graph = getattr(tick, "graph", None)
    assert isinstance(graph, tick_graph.TickGraph) == (kind in ("a2c", "a2c_stacked"))


@pytest.mark.parametrize("stacked", [False, True], ids=["loop", "stacked"])
def test_flat_views_hold_and_train_like_the_train_states(stacked):
    """The graph's flat buffer: one aligned view a leaf, rebuilt into the
    train states' structure, trains to the same bits as the states it
    copies (autograd through float views of a byte buffer)."""
    tick, state, ts, key = small_loop(stacked)
    ins = tick_graph.leaves(ts) + [key]
    flat = torch.empty(tick_graph.flat_bytes(ins), dtype=torch.uint8)
    views = tick_graph.flat_views(flat, ins)
    assert [v.data_ptr() % 16 for v in views] == [0] * len(views)
    for v, t in zip(views, ins):
        v.copy_(t)
    like = tick_graph.rebuild(ts, iter(views[:-1]))
    assert type(like) is type(ts) and tick_graph.leaves(like) == views[:-1]
    a = training_loop._loop_body(tick, state.clone(), ts, key)
    b = training_loop._loop_body(tick, state.clone(), like, views[-1])
    for x, y in zip(tick_graph.leaves(a[1]) + [a[2], a[4]], tick_graph.leaves(b[1]) + [b[2], b[4]]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("counts,want", [({}, None), ({"learn_ticks": 8, "host_syncs": 8}, 0.0),
                                         ({"learn_ticks": 8, "tick_graph_replays": 7}, 0.875)],
                         ids=["no-ticks", "no-replays", "replays"])
def test_replays_reader(counts, want):
    """0 from a program without the counter (the parent), replays over
    ticks with it, nothing without ticks."""
    run = type("Run", (), {"traced_calls": 20,
                           "driver": type("D", (), {"counts": counts})()})()
    assert core.plugin("metrics", "a2c.graph_replays_per_tick").read(run) == want


def _bits(t):
    return t.reshape(-1).contiguous().view(torch.uint8)


def _gap(a, b):
    d = float((a.double() - b.double()).abs().max())
    return 0.0 if d == 0 else d / float(b.double().abs().max())


MODES = {"f32": {}, "f32_slots": {"learner_slots_per_class": 12},
         "f32_stacked": {"stacked": True, "learner_slots_per_class": 12},
         "bf16": {"compute_dtype": torch.bfloat16},
         "bf16_slots": {"compute_dtype": torch.bfloat16, "learner_slots_per_class": 12},
         "bf16_stacked": {"compute_dtype": torch.bfloat16, "stacked": True,
                          "learner_slots_per_class": 12}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_graph_equals_eager_on_the_card(mode):
    """At 2048 x 128 with the cell's four nets, 10 epochs of the graphed
    loop (2 eager warm-ups, the capture, 7 replays) against 10 eager ones
    from equal inputs: the state's bits equal every tick (actions and
    memory included), the train states within the cell's memory limit;
    what each call was given and returned is unchanged by the next call;
    counters count one tick a call, one capture, a replay a graphed call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cfg = EnvConfig(num_worlds=2048, init_agents=32, max_agents=CONFIG["max_agents"],
                    num_species=CONFIG["num_species"],
                    reward_setting=RewardSetting(CONFIG["reward_setting"]))
    models = [ActorCritic(arch, device=dev) for arch in CONFIG["species_nets"]]
    kw = dict(MODES[mode], lr=CONFIG["lr"], gamma=CONFIG["gamma"])
    graphed, opt = a2c.make_train_tick(models, cfg, **kw)
    eager, _ = a2c.make_train_tick(models, cfg, **kw)
    eager.graph = None
    k = rng.key(20, dev)
    ts = (a2c.init_stacked_train_state(models, k, opt) if kw.get("stacked")
          else a2c.init_train_states(models, k, opt))
    ge = (init_state(cfg, 20, dev), ts, rng.key(21, dev))
    gg = (ge[0].clone(), ts, ge[2])
    profiling.reset_counts()
    counted, kept = [], None
    for i in range(10):
        ge = training_loop.run_tick(eager, *ge[:3])
        given = gg[1:3]
        before = profiling.counts()
        gg = training_loop.run_tick(graphed, *gg[:3])
        after = profiling.counts()
        counted.append({c: after.get(c, 0) - before.get(c, 0)
                        for c in ("learn_ticks", "host_syncs", "tick_graph_captures",
                                  "tick_graph_replays")})
        for f in FIELDS:
            assert torch.equal(_bits(getattr(gg[0], f)), _bits(getattr(ge[0], f))), (i, f)
        for a, b in zip(tick_graph.leaves(gg[1:3]), tick_graph.leaves(ge[1:3])):
            assert _gap(a, b) <= LIMITS["memory_gap"], i
        assert list(gg[3]) == list(ge[3])
        if kept is not None:
            for t, c in zip(*kept):
                assert torch.equal(t, c), i
        now = tick_graph.leaves(given) + tick_graph.leaves(gg[1:3])
        kept = (now, [t.clone() for t in now])
    assert [c["learn_ticks"] for c in counted] == [1] * 10
    assert [c["host_syncs"] for c in counted] == [1] * 10
    assert sum(c["tick_graph_captures"] for c in counted) == 1
    assert ([c["tick_graph_replays"] for c in counted]
            == [0] * tick_graph.WARMUP_CALLS + [1] * (10 - tick_graph.WARMUP_CALLS))
