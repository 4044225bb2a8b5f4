"""The readers of the program's own spans and counters: on a trace built by
hand with fixed intervals, each gives the self time, overlap and count
worked out by hand; in a 4-world CPU run, the traced run reports the host
readers and the counter, and no device reader, and the untraced run none."""

import pytest

from portbench import core, run, spans
from portbench.trace import Trace

SIX = ("manager.env_host_ms", "manager.export_host_ms", "manager.sync_wait_ms",
       "manager.launches_per_call", "manager.program_idle_ms", "manager.host_syncs_per_call")
MS = 1_000_000
"""The hand-built trace's unit: its times are whole ms."""


def hand_trace(program=True):
    """Two calls in a 1,000 ms window. The device runs k1 (launched in the
    systems wrapper), k2 (in the order), k3 (outside every program span) and
    k4 (in the nonzero read)."""
    t = Trace.__new__(Trace)
    t.start_ns, t.end_ns, t.window_s = 0, 1000 * MS, 1.0
    named = {"portbench.step": [(90, 510)],
             "mbots.manager.step": [(100, 500)],
             "mbots.env.systems": [(120, 200)],
             "mbots.env.raycast": [(200, 260)],
             "mbots.sync.inside_env": [(240, 250)],
             "mbots.manager.order": [(300, 400)],
             "mbots.sync.species_starts": [(320, 380)],
             "mbots.manager.gather": [(600, 700)],
             "mbots.sync.nonzero": [(620, 640)]}
    launches = [(x * MS, x * MS + 1, "cudaLaunchKernel") for x in (130, 350, 550, 630)]
    t.host = sorted([(s * MS, e * MS, k) for k, v in named.items() for s, e in v
                     if program or not k.startswith("mbots.")] + launches)
    t.ops = [(s * MS, e * MS, n, c) for s, e, n, c in
             [(150, 450, "k1", 1), (460, 480, "k2", 2), (650, 660, "k4", 4), (800, 900, "k3", 3)]]
    # an id map that points k1 outside every span, as the card's traces do
    # for the CPU operators sharing an id with a launch: the launch calls count
    t.launch = {1: 550 * MS, 2: 350 * MS, 3: 800 * MS, 4: 630 * MS}
    return t


def hand_run(trace, calls=2):
    return run.Run(trace=trace, traced_calls=calls)


# Worked out by hand, ms a call over 2 calls:
#   env: (120, 260) less the read at (240, 250): 130 -> 65
#   SimManager: (100, 500) + (600, 700) = 500, less env (120, 260) and the reads
#     (320, 380), (620, 640): 500 - 140 - 60 - 20 = 280 -> 140
#   reads: 10 + 60 + 20 = 90 -> 45
#   launches inside program spans: k1, k2, k4 -> 1.5
#   device busy (150, 450), (460, 480), (650, 660), (800, 900); idle inside
#     program spans: (100, 150), (450, 460), (480, 500), (600, 650), (660, 700)
#     = 170 -> 85
WANT = {"manager.env_host_ms": 65.0, "manager.export_host_ms": 140.0,
        "manager.sync_wait_ms": 45.0, "manager.launches_per_call": 1.5,
        "manager.program_idle_ms": 85.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_hand_built_trace(name):
    got = core.plugin("metrics", name).read(hand_run(hand_trace()))
    assert got == pytest.approx(WANT[name], abs=1e-9)


def test_host_readers_add_up_to_the_program_spans():
    r = hand_run(hand_trace())
    total = sum(core.plugin("metrics", n).read(r) for n in
                ("manager.env_host_ms", "manager.export_host_ms", "manager.sync_wait_ms"))
    assert total == pytest.approx(spans.ms_per_call(r, spans.named(r.trace, "mbots.")))


@pytest.mark.parametrize("name", SIX[:5])
def test_readers_report_nothing_without_program_spans(name):
    reader = core.plugin("metrics", name)
    assert reader.read(hand_run(hand_trace(program=False))) is None
    assert reader.read(hand_run(None, calls=0)) is None


def test_interval_arithmetic():
    a = spans.union([(5, 9), (0, 2), (1, 3), (9, 10), (12, 12)])
    assert a == [(0, 3), (5, 10)]
    assert spans.intersect(a, [(2, 6), (8, 20)]) == [(2, 3), (5, 6), (8, 10)]
    assert spans.subtract(a, [(2, 6), (8, 20)]) == [(0, 2), (6, 8)]
    assert spans.complement(a, -1, 11) == [(-1, 0), (3, 5), (10, 11)]
    assert spans.length(a) == 8


def test_sync_counter_reader(monkeypatch):
    from madrona_bots_tpu_torch.utils import profiling
    reader = core.plugin("metrics", "manager.host_syncs_per_call")
    monkeypatch.setattr(profiling, "_counts", {"steps": 4, "host_syncs": 9})
    assert reader.read(hand_run(hand_trace())) == 2.25
    monkeypatch.setattr(profiling, "_counts", {})
    assert reader.read(hand_run(hand_trace())) is None
    monkeypatch.delattr(profiling, "counts")      # a program without counters
    assert reader.read(hand_run(hand_trace())) is None


def test_cpu_runs_report_the_host_readers_when_traced_only():
    cell = "upstream-w2048.manager-dense"
    plain, traced = (run.measure(cell, 2**31 + 23, 0.3, trace, device="cpu",
                                 config_overrides={"num_worlds": 4}) for trace in (False, True))
    assert plain["correct"] and traced["correct"]
    assert not set(SIX) & set(plain["metrics"])
    host = {"manager.env_host_ms", "manager.export_host_ms", "manager.sync_wait_ms",
            "manager.host_syncs_per_call"}
    assert set(SIX) & set(traced["metrics"]) == host
    for name in host:
        assert traced["metrics"][name]["value"] > 0, name
    assert traced["metrics"]["manager.host_syncs_per_call"]["value"] == pytest.approx(2, abs=0.1)
