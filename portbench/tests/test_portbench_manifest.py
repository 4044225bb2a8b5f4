"""BENCHMARK.json against the contract's shape, and every name it gives
against the files the harness finds by that name."""

import json
import re

import pytest

from portbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = core.manifest()


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(one_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_entry_keys(section):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[section]
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e and section != "end_to_end" and section != "per_layer":
                assert one_line(e[k]), (e["name"], k)
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and e["chips"] == 1
        if section == "configs":
            assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16


def test_metrics_sources_moves_and_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and one_line(m["layer"])
        assert set(m["workloads"]) <= cells
        layers.setdefault(m["layer"], set()).add(m["name"])
    for cell in cells:
        assert core.cell_metrics(BENCH, cell, "per_layer"), cell
        reported = [m["name"] for m in core.cell_metrics(BENCH, cell, "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2, cell


def test_every_name_has_its_file():
    for c in BENCH["configs"]:
        data = core.data("configs", c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert data["reduced"] == c["reduced"] and data["source"] == c["source"]
    for w in BENCH["workloads"]:
        data = core.data("workloads", w["name"])
        assert data["config"] == w["config"] and data["why"] == w["why"]
        assert core.plugin("drivers", data["driver"]).Driver
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(core.plugin("metrics", m["name"]).read)


def test_run_seconds_fit_the_check_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
