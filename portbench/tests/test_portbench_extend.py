"""A cell, a configuration and a per-layer metric are added as new files
plus entries in BENCHMARK.json, with no edit to a file that is there: a
throwaway cell in a copy of the benchmark runs and reports the new metric."""

import json
import shutil
import subprocess
import sys

from portbench.tests.conftest import ROOT

CODE = """
import json, sys
sys.path[:0] = [{root!r}, {program!r}]   # the copy's portbench first, then the port
from portbench import run
print(json.dumps([run.measure("tiny.ticks", 3, 0.3, trace, device="cpu")
                  for trace in (False, True)]))
"""


def test_throwaway_cell_from_new_files_only(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"

    config = json.loads((pb / "configs/upstream-w2048.json").read_text())
    config.update(name="tiny", num_worlds=4)
    (pb / "configs/tiny.json").write_text(json.dumps(config))
    cell = json.loads((pb / "workloads/upstream-w2048.manager-dense.json").read_text())
    cell.update(name="tiny.ticks", config="tiny", why="a throwaway cell", trace_calls=4)
    cell["check"]["within"] = 3
    (pb / "workloads/tiny.ticks.json").write_text(json.dumps(cell))
    (pb / "metrics/tiny.calls.py").write_text("def read(run):\n    return len(run.call_s)\n")
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny.json", "reduced": ["num_worlds"],
                             "why": "throwaway"})
    bench["workloads"].append({"name": "tiny.ticks", "config": "tiny", "traffic": "ticks",
                               "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "tiny.calls", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "SimManager exports",
                               "moves": "world_steps_per_s", "workloads": ["tiny.ticks"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", CODE.format(root=str(tmp_path), program=str(ROOT))],
                         cwd=tmp_path, capture_output=True, text=True, check=True).stdout
    plain, traced = json.loads(out.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"world_steps_per_s", "call_ms_p95", "setup_s"}
    assert set(traced["metrics"]) == {"tiny.calls"}
    assert traced["metrics"]["tiny.calls"]["value"] >= 1
    after = {p: p.read_bytes() for p in before}
    assert after == before
