"""The port's profiling helpers and tools: `utils/profiling.py`,
`tools/prof.py` (CUDA only) and `tools/plot_curves.py` (its series equal the
JAX package's)."""

import os

import numpy as np
import pytest
import torch

from madrona_bots_tpu.tools import plot_curves as jplot
from madrona_bots_tpu_torch.tools import plot_curves, prof
from madrona_bots_tpu_torch.utils.profiling import StepTimer, device_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVES = os.path.join(REPO, "artifacts", "lcurve", "multiseed_r3.jsonl")


def test_step_timer():
    t = StepTimer()
    x = torch.ones(64)
    for _ in range(3):
        out = t.timed(lambda a: {"y": [a * 2, (a + 1,)]}, x)
    assert float(out["y"][0].sum()) == 128.0
    assert len(t.times) == 3 and all(s >= 0 for s in t.times)
    s = t.summary()
    assert s["n"] == 2 and s["min_s"] <= s["mean_s"] <= s["max_s"]
    assert t.fps(8) > 0


def test_device_trace(tmp_path):
    with device_trace(None):
        y = torch.ones(4) + 1
    assert float(y.sum()) == 8.0
    with device_trace(str(tmp_path)):
        torch.ones(256, 256) @ torch.ones(256, 256)
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))


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
