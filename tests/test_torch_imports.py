"""The port imports torch, never jax, and nothing of the JAX package; its
entry points default to CUDA and never fall back to the CPU quietly."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import madrona_bots_tpu_torch
from madrona_bots_tpu_torch import EnvConfig, init_state
from madrona_bots_tpu_torch.ops import _build

PKG = pathlib.Path(madrona_bots_tpu_torch.__file__).parent
REPO = PKG.parent
MODULES = sorted("madrona_bots_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
                 for p in PKG.rglob("*.py") if p.name != "__init__.py")


def test_import_pulls_in_no_jax():
    """Importing every module pulls in no JAX, nothing of the JAX package
    and no matplotlib (the viewers import it where they draw: the card's
    machine may lack it)."""
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
              "or m == 'flax' or m == 'madrona_bots_tpu' "
              "or m.startswith('madrona_bots_tpu.') "
              "or m == 'matplotlib' or m.startswith('matplotlib.')]\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO))
                                        for p in PKG.rglob("*.py"))
                         + ["chip_smoke.py", "kernel_times.py"])
def test_source_imports_no_jax_package(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "madrona_bots_tpu"), (path, n)


def test_entry_point_defaults_to_cuda():
    cfg = EnvConfig(num_worlds=2, init_agents=8, max_agents=16)
    if torch.cuda.is_available():
        assert init_state(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            init_state(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_state(cfg, device="cuda")
    assert init_state(cfg, device="cpu").device.type == "cpu"


def test_kernel_library_names_follow_sources():
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(f"lib{name}_")
    assert _build.library_path("systems") != _build.library_path("raycast")


def test_build_keeps_ptxas_report(tmp_path, monkeypatch):
    """A library loaded from the build cache still has its ptxas report; a
    library without its report is built again. nvcc is a stand-in script
    here that writes the output and one report line."""
    nvcc = tmp_path / "nvcc"
    calls = tmp_path / "calls"
    nvcc.write_text('#!/bin/sh\n'
                    f'echo x >> "{calls}"\n'
                    'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
                    ': > "$out"\n'
                    'echo "ptxas info    : Used 40 registers, 0 bytes spill stores"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    n_calls = lambda: len(calls.read_text().split()) if calls.exists() else 0
    reports = []
    for _ in range(2):
        _, report = _build.build(("raycast", "row_gather"))
        reports.append(report)
    assert n_calls() == 2 and reports[0] == reports[1]
    assert reports[0].count("Used 40 registers") == 2 and "[row_gather.cu]" in reports[0]
    assert _build.library_path("raycast").exists()
    _build.report_path("raycast").unlink()
    _, report = _build.build(("raycast",))
    assert n_calls() == 3 and report.startswith("[raycast.cu]\nptxas info")


@pytest.mark.parametrize("script", ["chip_smoke.py", "kernel_times.py"])
def test_card_scripts_exit_nonzero_without_a_card(script):
    """Without a visible card each script exits 1 and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(REPO / script)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 1 and p.stdout == "", (p.returncode, p.stdout, p.stderr)


def test_training_cli_defaults_to_cuda(tmp_path):
    """The CLI runs on CUDA unless `--device cpu` is given; without a card
    it raises before it writes anything."""
    from madrona_bots_tpu_torch.learn import training_loop
    args = ["--num_worlds", "2", "--num_epochs", "1", "--create_universe",
            "--model_save_dir", str(tmp_path), "--hidden_dim", "8"]
    if torch.cuda.is_available():
        assert training_loop.build_parser().parse_args(args).device is None
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        training_loop.main(args)
    assert not any(tmp_path.iterdir())
