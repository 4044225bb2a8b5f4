"""The A2C cell's readers and FLOP count: on a trace built by hand with
fixed intervals each reader gives the number worked out by hand; the
FLOPs of a small net by hand; in a 4-world CPU run the traced run reports
the host readers and no device reader."""

import pytest

from portbench import core, flops, run
from portbench.tests.test_portbench_spans import MS, hand_run
from portbench.trace import Trace

CELL = "upstream-a2c-w2048.train"
SIX = ("a2c.mfu", "a2c.device_idle", "a2c.learn_host_ms", "a2c.draw_launches_per_tick",
       "a2c.launches_per_tick", "a2c.host_syncs_per_tick")


def a2c_trace(program=True):
    """Two ticks in a 1,000 ms window. The window's thread launches k1 in the
    systems wrapper, k2 and k3 in the draw, k5 outside every program span
    (the loop's key split) and k6 in the metrics read; k4 runs the backward,
    launched from autograd's thread inside the gradient span."""
    t = Trace.__new__(Trace)
    t.start_ns, t.end_ns, t.window_s = 0, 1000 * MS, 1.0
    named = {"portbench.tick": [(0, 900)],
             "mbots.learn.tick": [(100, 700)],
             "mbots.env.systems": [(100, 200)],
             "mbots.learn.rows": [(200, 250)],
             "mbots.learn.draw": [(300, 350)],
             "mbots.learn.grad": [(350, 500)],
             "mbots.learn.adam": [(500, 600)],
             "mbots.sync.metrics": [(750, 800)]}
    launches = [(x * MS, x * MS + 1, "cudaLaunchKernel") for x in (150, 310, 320, 50)]
    launches.append((760 * MS, 760 * MS + 1, "cudaMemcpyAsync"))
    t.host = sorted([(s * MS, e * MS, k) for k, v in named.items() for s, e in v
                     if program or not k.startswith("mbots.")] + launches)
    t.ops = sorted((s * MS, e * MS, n, c) for s, e, n, c in
             [(160, 260, "k1", 1), (320, 330, "k2", 2), (330, 340, "k3", 3),
              (400, 450, "k4", 4), (60, 70, "k5", 5), (770, 780, "k6", 6)])
    t.launch = {}
    return t


def a2c_run(trace, calls=2):
    r = hand_run(trace, calls)
    r.config, r.driver = core.data("configs", "upstream-a2c-w2048"), None
    return r


# Worked out by hand, a tick over 2 ticks:
#   learner: (100, 700) less env (100, 200); no sync inside -> 500 -> 250 ms
#   draw launches: k2, k3 -> 1
#   launches in program spans: 6 device operations less k5 (launched at 50,
#     outside every program span) -> 5 -> 2.5
#   device busy 100 + 10 + 10 + 50 + 10 + 10 = 190 of 1000 ms -> idle 81 %
#   mfu: 2 ticks of a2c_tick_flops over 1 s at 67 TFLOP/s
WANT = {"a2c.learn_host_ms": 250.0, "a2c.draw_launches_per_tick": 1.0,
        "a2c.launches_per_tick": 2.5, "a2c.device_idle": 81.0,
        "a2c.mfu": 100 * 2 * 110_998_061_056 / 67e12}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_hand_built_trace(name):
    got = core.plugin("metrics", name).read(a2c_run(a2c_trace()))
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", ["a2c.learn_host_ms", "a2c.draw_launches_per_tick",
                                  "a2c.launches_per_tick", "a2c.host_syncs_per_tick"])
def test_readers_report_nothing_from_a_program_without_them(name):
    """The parent of the learner's spans and counters: no metric, no error."""
    reader = core.plugin("metrics", name)
    assert reader.read(a2c_run(a2c_trace(program=False))) is None
    assert reader.read(a2c_run(None, calls=0)) is None


def test_sync_reader_reads_the_runs_counts():
    reader = core.plugin("metrics", "a2c.host_syncs_per_tick")
    r = a2c_run(a2c_trace())
    r.driver = type("D", (), {"counts": {"learn_ticks": 8, "host_syncs": 10}})()
    assert reader.read(r) == 1.25
    r.driver.counts = {"steps": 3, "host_syncs": 6}        # a program without learn_ticks
    assert reader.read(r) is None


def test_flops_of_a_net_by_hand():
    arch = {"layers": [{"type": "linear", "in_features": 3, "out_features": 4},
                       {"type": "linear", "in_features": 4, "out_features": 4},
                       {"type": "activation", "activation": "Tanh"}],
            "recurrent": {"type": "GRU", "input_dim": 4, "hidden_dim": 2},
            "actor": [{"type": "linear", "in_features": 2, "out_features": 5},
                      {"type": "activation", "activation": "ReLU"},
                      {"type": "linear", "in_features": 5, "out_features": 6}],
            "critic": [{"type": "linear", "in_features": 2, "out_features": 5},
                       {"type": "activation", "activation": "ReLU"},
                       {"type": "linear", "in_features": 5, "out_features": 1}]}
    # 12 + 16 + GRU 3 * 2 * (4 + 2) = 36, actor 10 + 30, critic 10 + 5
    assert flops.forward_macs(arch) == 119
    config = {"num_worlds": 3, "max_agents": 8, "num_species": 2, "species_nets": [arch] * 2}
    assert flops.a2c_tick_flops(config) == 2 * 4 * 12 * 2 * 119
    cell = core.data("configs", "upstream-a2c-w2048")
    assert [flops.forward_macs(a) for a in cell["species_nets"]] == [53504, 69888, 48896,
                                                                      39424]


def test_cpu_runs_report_the_host_readers_when_traced_only():
    plain, traced = (run.measure(CELL, 2**31 + 29, 0.3, trace, device="cpu",
                                 config_overrides={"num_worlds": 4}) for trace in (False, True))
    assert plain["correct"] and traced["correct"], (plain["checks"], traced["checks"])
    assert not set(SIX) & set(plain["metrics"])
    assert set(SIX) & set(traced["metrics"]) == {"a2c.learn_host_ms", "a2c.host_syncs_per_tick"}
    assert traced["metrics"]["a2c.learn_host_ms"]["value"] > 0
    assert traced["metrics"]["a2c.host_syncs_per_tick"]["value"] == 1.0
