"""The port's viewers, renderer, stdin test driver and viewer-embedded
drivers, one case per test of tests/test_viz.py (headless Agg backend, on
the CPU); the palette and the web viewer's JSON snapshots equal the JAX
package's."""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from madrona_bots_tpu_torch.api.manager import SimManager  # noqa: E402
from madrona_bots_tpu_torch.viz import ScriptBotsViewer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_save_frame(tmp_path):
    from madrona_bots_tpu_torch.viz.render import save_frame
    mgr = SimManager(0, 1, 3, 16, device="cpu")
    mgr.step()
    path = save_frame(mgr.state, 0, mgr.cfg, str(tmp_path / "frame.png"))
    assert os.path.exists(path) and os.path.getsize(path) > 5000


def test_viewer_headless_loop(tmp_path):
    viewer = ScriptBotsViewer(0, 1, 5, 16, frame_dir=str(tmp_path / "frames"),
                              frame_every=2, device="cpu")
    mgr = viewer.get_sim_mgr()
    steps = []

    def step_fn(epoch, carry):
        mgr.step()
        steps.append(epoch)

    viewer.loop(4, step_fn, None)
    assert steps == [1, 2, 3, 4]
    assert len(os.listdir(tmp_path / "frames")) >= 2


def test_semantic_palette():
    from madrona_bots_tpu.viz import render as jrender
    from madrona_bots_tpu_torch.viz.render import SPECIES_COLORS, semantic_to_rgb
    sem = np.array([-1, 0, 1, 2, 3, 4], np.int8)
    rgb = semantic_to_rgb(sem)
    assert rgb.shape == (6, 3)
    assert len({tuple(r) for r in rgb.round(3)}) == 6
    np.testing.assert_array_equal(rgb, jrender.semantic_to_rgb(sem))
    np.testing.assert_array_equal(SPECIES_COLORS, jrender.SPECIES_COLORS)


def test_stdin_test_driver():
    """Drive the stdin test driver through a pipe (test.cpp parity)."""
    proc = subprocess.run(
        [sys.executable, "-m", "madrona_bots_tpu_torch.tools.test_driver",
         "--device", "cpu"],
        input="w\nr\nq\n", capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-2000:]
    depth_lines = [ln for ln in proc.stdout.splitlines() if len(ln.split()) == 32]
    assert len(depth_lines) == 2
    assert all(0 <= int(v) <= 255 for ln in depth_lines for v in ln.split())
    assert proc.stdout.strip().endswith("bye")


class _FakeKey:
    def __init__(self, key):
        self.key = key


def test_viewer_keyboard_chain(tmp_path):
    """_on_key -> _apply_keys -> set_action -> the action reaches the
    simulator at the next step (the gfx.cpp:176-205 scheme)."""
    viewer = ScriptBotsViewer(0, 2, 7, 16, frame_dir=str(tmp_path / "f"), device="cpu")
    mgr = viewer.get_sim_mgr()
    viewer._on_key(_FakeKey("up"))
    assert viewer.inspect_world == 1
    viewer._on_key(_FakeKey("down"))
    viewer._on_key(_FakeKey("down"))
    assert viewer.inspect_world == 0
    viewer._on_key(_FakeKey("right"))
    assert viewer.inspect_agent == 1

    viewer._on_key(_FakeKey("w"))
    viewer._on_key(_FakeKey("r"))
    slot = viewer._selected_slot()
    viewer._apply_keys()
    assert not viewer._keys
    sensor_idx = mgr.sensor_index_tensor().to_numpy()
    offset = mgr.agent_offset_for_world(viewer.inspect_world)
    row = int(sensor_idx[offset + viewer.inspect_agent, 0])
    np.testing.assert_array_equal(mgr.action_tensor(False).to_numpy()[row], [1, 0, 1, 0, 0, 0])

    h0 = float(mgr.state.heading[viewer.inspect_world, slot])
    mgr.step()
    assert bool(mgr.state.alive[viewer.inspect_world, slot])
    np.testing.assert_array_equal(mgr.state.action[viewer.inspect_world, slot].numpy(),
                                  [1, 0, 1, 0, 0, 0])
    assert float(mgr.state.heading[viewer.inspect_world, slot]) != h0


def test_env_app_driver(tmp_path, monkeypatch):
    """learn/env_app.py: the legacy training step inside ScriptBotsViewer.loop
    (reference learn/env_app.py:1-87); learn/app.py steps the viewer."""
    monkeypatch.chdir(tmp_path)
    from madrona_bots_tpu_torch.learn import app, env_app
    params = env_app.main(["--num_worlds", "2", "--num_epochs", "3", "--hidden_dim", "16",
                           "--frame_dir", str(tmp_path / "frames"), "--device", "cpu"])
    assert len(params) == 4 and all(bool(torch.isfinite(p).all()) for p in params)
    assert os.listdir(tmp_path / "frames")
    app.main(["--num_epochs", "2", "--device", "cpu"])
    assert os.listdir(tmp_path / "viewer_frames")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            app.main(["--num_epochs", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            ScriptBotsViewer(0, 1, 0, 16)


def test_web_viewer_serves_state_and_steps():
    """viz/web.py: the JSON endpoint returns a renderable snapshot, /step
    advances the simulator, keys drive the selected agent."""
    from madrona_bots_tpu_torch.viz.web import WebViewer, make_server
    viewer = WebViewer(num_worlds=2, seed=3, init_agents=16, device="cpu")
    srv = make_server(viewer, 0)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{port}"
        assert "<canvas" in urllib.request.urlopen(url + "/", timeout=120).read().decode()
        s0 = json.loads(urllib.request.urlopen(url + "/state", timeout=300).read())
        for k in ("agents", "food", "depth", "semantic", "lim", "alive"):
            assert k in s0, k
        assert len(s0["depth"]) == 32 and s0["alive"] > 0
        s1 = json.loads(urllib.request.urlopen(url + "/step?keys=w,r", timeout=300).read())
        assert s1["step"] == s0["step"] + 1
        s2 = json.loads(urllib.request.urlopen(url + "/step?keys=arrowup", timeout=300).read())
        assert s2["world"] == 1
    finally:
        srv.shutdown()
        srv.server_close()


def test_web_snapshots_equal_jax():
    """Snapshots after each of 3 steps, with keys, equal the JAX WebViewer's
    JSON byte for byte."""
    from madrona_bots_tpu.viz.web import WebViewer as JaxWebViewer
    from madrona_bots_tpu_torch.viz.web import WebViewer
    jv = JaxWebViewer(num_worlds=2, seed=3, init_agents=16, use_pallas=False)
    tv = WebViewer(num_worlds=2, seed=3, init_agents=16, device="cpu")
    for keys in (("w", "r"), ("arrowup", "arrowright", "space"), ("b", "s")):
        want = json.dumps(jv.step_and_snapshot(keys))
        got = json.dumps(tv.step_and_snapshot(keys))
        assert got == want
    assert json.loads(got)["world"] == 1 and json.loads(got)["agents"]
