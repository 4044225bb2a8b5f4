"""Each cell's run at 4 worlds on the CPU, judged against the plain
reference; the same run with the timed path broken underneath, which has to
come out not correct; and the control, which has to fail a limit."""

import pytest
import torch

from portbench import calibrate, compare, core, run

CELLS = sorted(p.stem for p in (core.HERE / "workloads").glob("*.json"))
"""Every cell with a workload file."""
SMALL = {"num_worlds": 4}


def measure(cell, seconds=0.5, seed=2**31 + 11):
    return run.measure(cell, seed, seconds, False, device="cpu", config_overrides=SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_against_the_reference(cell):
    r = measure(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    want = {m["name"] for m in core.cell_metrics(core.manifest(), cell, "end_to_end")}
    assert set(r["metrics"]) == want
    assert list(r)[-1] == "checks"


def _unchanged_manager(monkeypatch):
    from madrona_bots_tpu_torch.env import env
    monkeypatch.setattr(env, "step", lambda state, cfg, use_kernels=True: state)


def _half_manager(monkeypatch):
    from madrona_bots_tpu_torch.env import env
    from madrona_bots_tpu_torch.env.state import FIELDS
    step = env.step

    def half(state, cfg, use_kernels=True):
        old = state.clone()
        new = step(state, cfg, use_kernels)
        W = new.alive.shape[0]
        return new.replace(**{f: torch.cat([getattr(new, f)[: W // 2], getattr(old, f)[W // 2:]])
                              for f in FIELDS if getattr(new, f).dim() and
                              getattr(new, f).shape[0] == W})
    monkeypatch.setattr(env, "step", half)


def _altered_manager(monkeypatch):
    from madrona_bots_tpu_torch.utils import native

    def gather(src, perm):
        out = src.index_select(0, perm)
        if out.numel():
            out.view(-1)[0] += 1
        return out
    monkeypatch.setattr(native, "gather_rows", gather)


def _tally_off_by_one(monkeypatch):
    """One agent too many in each world's fullest chunk tally: the bilinear
    `surrounding` of the agents around it moves by less than one."""
    from madrona_bots_tpu_torch.env import systems
    tallies = systems.chunk_tallies

    def off(alive, cidx, speed_q, cfg):
        agents, movement = tallies(alive, cidx, speed_q, cfg)
        return agents.scatter_add(1, agents.argmax(1, keepdim=True),
                                  torch.ones_like(agents[:, :1])), movement
    monkeypatch.setattr(systems, "chunk_tallies", off)


FAULTS = {"unchanged": _unchanged_manager, "half_batch": _half_manager,
          "altered_answer": _altered_manager, "tally_off_by_one": _tally_off_by_one}
CASES = [(c, f) for c in CELLS for f in FAULTS]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = measure(cell)
    assert not r["correct"], r["checks"]
    assert r["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    wl = core.data("workloads", cell)
    wl["check"]["within"] = 3            # keep the CPU's window short
    row = calibrate.readings(cell, 2**31 + 5, True, "cpu", SMALL, wl=wl)
    limits = wl["check"]["limits"]
    assert compare.judge(row["program"], limits)[0] == 0, row["program"]
    assert compare.judge(row["control"], limits)[0] > 0, row["control"]
