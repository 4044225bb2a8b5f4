"""The port's profiling helpers and tools: `utils/profiling.py` (spans,
counters and the TensorBoard trace, with the SimManager's and the A2C
tick's spans and sync sites), `tools/prof.py` (CUDA only) and
`tools/plot_curves.py` (its series equal the JAX package's)."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from madrona_bots_tpu.tools import plot_curves as jplot
from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.api import SimManager
from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.env.state import init_state
from madrona_bots_tpu_torch.learn import a2c, training_loop
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator
from madrona_bots_tpu_torch.env.state import FIELDS
from madrona_bots_tpu_torch.tools import plot_curves, prof
from madrona_bots_tpu_torch.utils import profiling
from madrona_bots_tpu_torch.utils.profiling import device_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVES = os.path.join(REPO, "artifacts", "lcurve", "multiseed_r3.jsonl")

NINE = ("depth", "semantic", "reward", "position", "health", "surrounding", "action",
        "stats", "hidden_state")
STEP_SPANS = ("mbots.manager.step", "mbots.manager.flush", "mbots.env.systems",
              "mbots.env.raycast", "mbots.manager.order", "mbots.manager.refresh",
              "mbots.manager.gather", "mbots.manager.shift", "mbots.sync.species_starts",
              "mbots.sync.nonzero")
"""The spans of one benchmark-shaped call."""
ENV_DRAWS = 32
"""rng calls of one plain env step (all on the plain threefry), each
`fold_in`, `random_bits` or `threefry2x32` one: the food spawn's 22 (two
key folds, then for each of its four draws a fold and a `randint`'s two
hashes and two word draws) and the respawn's 10 (two key folds, then a fold
and a `uniform` for each of the 4 species)."""
TICK_DRAWS = 1 + 4 + 4
"""rng calls of one A2C epoch besides its env step: the loop's key split,
a species key fold and a categorical draw for each of the 4 species."""


def manager(seed=5):
    return SimManager(0, 4, seed, 32, device="cpu")


def benchmark_call(mgr, i):
    """What the SimManager loop of upstream users does in a call: one-hot
    actions into `action_tensor`, a step, the 12 getters, the shift."""
    act = mgr.action_tensor().to_torch()
    gen = torch.Generator().manual_seed(i)
    act.copy_(torch.nn.functional.one_hot(torch.randint(0, 6, (act.shape[0],), generator=gen),
                                          6).to(torch.int32))
    mgr.step()
    out = [mgr.species_count_tensor().to_torch(), mgr.done_tensor().to_torch(),
           mgr.sensor_index_tensor().to_torch()]
    out += [getattr(mgr, f"{n}_tensor")(False).to_torch().clone() for n in NINE]
    mgr.shift_observations()
    return out


def program_spans(prof):
    """{span name: [(start, end)]} of a finished profiler's `mbots.*` events."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("mbots."):
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def within(inner, outer):
    """Each of `inner`'s intervals lies inside one of `outer`'s."""
    return all(any(s0 <= s and e <= e0 for s0, e0 in outer) for s, e in inner)


def test_span_off_is_the_shared_noop_and_counters_count(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler event {name!r} with no profiler recording")
    monkeypatch.setattr(profiling, "_event", refuse)
    a, b = profiling.span("mbots.manager.step"), profiling.span("mbots.env.raycast")
    assert a is b
    with a, b:
        pass
    profiling.reset_counts()
    profiling.count("steps")
    profiling.count("steps", 3)
    with profiling.host_sync("nonzero"):
        pass
    got = profiling.counts()
    assert got == {"steps": 4, "host_syncs": 1}
    got["steps"] = 0
    assert profiling.counts()["steps"] == 4
    profiling.reset_counts()
    assert profiling.counts() == {}


def test_span_under_a_profiler_is_a_profiler_event():
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with profiling.span("mbots.a"):
            with profiling.span("mbots.b"):
                torch.ones(4).add_(1)
    spans = program_spans(p)
    assert set(spans) == {"mbots.a", "mbots.b"}
    assert within(spans["mbots.b"], spans["mbots.a"])


def test_benchmark_call_emits_every_span_nested():
    mgr = manager()
    benchmark_call(mgr, 0)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        benchmark_call(mgr, 1)
    call = program_spans(p)
    assert set(call) == set(STEP_SPANS)
    assert len(call["mbots.manager.step"]) == 1 and len(call["mbots.sync.species_starts"]) == 1
    for name in ("mbots.env.systems", "mbots.env.raycast", "mbots.manager.order",
                 "mbots.manager.flush", "mbots.manager.refresh"):
        assert within(call[name][:1], call["mbots.manager.step"]), name
    assert within(call["mbots.sync.species_starts"], call["mbots.manager.order"])
    assert within(call["mbots.sync.nonzero"], call["mbots.manager.gather"])
    # a step plus the 12 getters: 3 fills (depth, semantic, reward, position,
    # health, surrounding and stats in one; done; sensor index)
    assert len(call["mbots.manager.gather"]) == 3
    with profile(activities=[ProfilerActivity.CPU]) as p:
        mgr.agent_offset_for_world(1)
        mgr.depth_tensor(False).to_numpy()
    assert set(program_spans(p)) == {"mbots.sync.world_offset", "mbots.manager.gather",
                                   "mbots.sync.to_numpy"}


def test_host_syncs_two_per_benchmark_call():
    mgr = manager()
    benchmark_call(mgr, 0)
    profiling.reset_counts()
    for i in range(3):
        benchmark_call(mgr, i)
    assert profiling.counts() == {"steps": 3, "host_syncs": 6, "rng_plain_calls": 3 * ENV_DRAWS}
    mgr.agent_offset_for_world(2)
    mgr.position_tensor(True).to_numpy()
    assert profiling.counts() == {"steps": 3, "host_syncs": 8, "rng_plain_calls": 3 * ENV_DRAWS}


def test_profiler_leaves_the_run_unchanged():
    plain, traced = manager(9), manager(9)
    for i in range(3):
        want = benchmark_call(plain, i)
        with profile(activities=[ProfilerActivity.CPU]):
            got = benchmark_call(traced, i)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype and torch.equal(w, g)
    for f in FIELDS:
        assert torch.equal(getattr(plain.state, f), getattr(traced.state, f)), f


LEARN_SPANS = {"mbots.learn.tick": 1, "mbots.learn.rows": 1, "mbots.learn.forward": 4,
               "mbots.learn.draw": 4, "mbots.learn.grad": 4, "mbots.learn.adam": 1,
               "mbots.learn.writeback": 5, "mbots.env.systems": 1, "mbots.env.raycast": 1,
               "mbots.sync.metrics": 1}
"""The spans of one epoch of the CLI's A2C loop, and how often each comes:
the forward, the draw and the gradient once a species, the write-back once
a species (its metric sums) and once for the tick."""


def a2c_loop(num_worlds=2, seed=3):
    """The CLI's A2C loop at `num_worlds` on the CPU: (tick, state, train
    states, key), seeded as `_train` seeds it."""
    cfg = EnvConfig(num_worlds=num_worlds)
    gen = SpeciesNetGenerator(69, 6, 32, 16, seed=seed)
    models = [ActorCritic(gen.sample_config()) for _ in range(4)]
    tick, opt = a2c.make_train_tick(models, cfg)
    k = rng.key(seed)
    ts = tuple(a2c.SpeciesTrainState(p, opt.init(p)) for p in
               (m.flatten(m.init(rng.fold_in(k, sp))) for sp, m in enumerate(models, 1)))
    return tick, init_state(cfg, seed, "cpu"), ts, rng.key(seed + 1)


def test_a2c_loop_spans_under_the_profiler_only(monkeypatch):
    tick, state, ts, key = a2c_loop()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        for _ in range(2):
            state, ts, key, _ = training_loop.run_tick(tick, state, ts, key)
    spans = program_spans(p)
    assert {k: len(v) for k, v in spans.items()} == {k: 2 * n for k, n in LEARN_SPANS.items()}
    for name in LEARN_SPANS:
        if name.startswith(("mbots.learn.", "mbots.env.")):
            assert within(spans[name], spans["mbots.learn.tick"]), name
    assert not within(spans["mbots.sync.metrics"], spans["mbots.learn.tick"])

    def refuse(name):
        raise AssertionError(f"a profiler event {name!r} with no profiler recording")
    monkeypatch.setattr(profiling, "_event", refuse)
    training_loop.run_tick(tick, state, ts, key)


def test_a2c_counters_and_one_sync_a_cli_epoch(tmp_path):
    """`learn_ticks` and `learner_rows` count 1 and W x 128 a tick (262,144
    at the benchmark's 2048 worlds), the CLI's loop reads the card once an
    epoch, and on the CPU every rng call of an epoch runs the plain
    threefry."""
    tick, state, ts, key = a2c_loop(num_worlds=3)
    profiling.reset_counts()
    for _ in range(2):
        state, ts, key, _ = training_loop.run_tick(tick, state, ts, key)
    assert profiling.counts() == {"learn_ticks": 2, "learner_rows": 2 * 3 * 128,
                                  "host_syncs": 2,
                                  "rng_plain_calls": 2 * (ENV_DRAWS + TICK_DRAWS)}
    profiling.reset_counts()
    training_loop.main(["--num_worlds", "2", "--num_epochs", "3", "--hidden_dim", "32",
                        "--create_universe", "--universe_id", "s", "--device", "cpu",
                        "--model_save_dir", str(tmp_path)])
    got = profiling.counts()
    assert got["learn_ticks"] == 3 and got["host_syncs"] == 3, got


def test_device_trace(tmp_path):
    with device_trace(None):
        y = torch.ones(4) + 1
    assert float(y.sum()) == 8.0
    mgr = manager()
    with device_trace(str(tmp_path)):
        mgr.step()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert files
    with open(tmp_path / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"mbots.manager.step", "mbots.env.raycast", "mbots.sync.species_starts"} <= names


def test_prof_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tools.prof runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        prof.main(["8", "16", "1"])


def test_plot_curves_series_equal_jax(tmp_path):
    want = jplot.load_series(CURVES)
    got = plot_curves.load_series(CURVES)
    assert got.keys() == want.keys() and len(got) > 0
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    jsonl = tmp_path / "run.metrics.jsonl"
    jsonl.write_text("".join(
        '{"epoch": %d, "species_1_total_loss": %f, "species_2_count": %d}\n' % (e, 1.0 / (e + 1), e)
        for e in range(5)))
    out = tmp_path / "curves.png"
    plot_curves.plot(str(jsonl), str(out))
    assert out.stat().st_size > 1000
