"""The import guard compares top-level module names whole; the reference
imports nothing of the port."""

import subprocess
import sys

from portbench import core
from portbench.tests.conftest import ROOT


def test_top_level_names_compared_whole():
    assert core.forbidden_modules(["madrona_bots_tpu_torch", "madrona_bots_tpu_torch.env",
                                   "jaxtyping", "flaxen", "numpy"]) == []
    assert core.forbidden_modules(["madrona_bots_tpu", "madrona_bots_tpu.env.state", "jax",
                                   "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib", "madrona_bots_tpu",
        "madrona_bots_tpu.env.state"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, pkgutil, importlib, portbench.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__):\n"
            "    importlib.import_module('portbench.reference.' + m.name)\n"
            "import portbench.yardstick, portbench.compare\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    tops = eval(out)
    assert "madrona_bots_tpu_torch" not in tops
    assert not core.forbidden_modules(tops)


def test_a_run_without_the_program_exits_without_a_result(tmp_path):
    """A checkout of BENCHMARK.json and portbench/ alone: no result line."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "upstream-w2048.manager-dense",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""
