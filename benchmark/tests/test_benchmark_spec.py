"""``BENCHMARK.json`` against the contract's shape and characters, and
every file it names."""

import json
import re

import pytest

from benchmark import spec
from benchmark.reference.params import Params

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
S = spec.load()


def line(x):
    return isinstance(x, str) and 1 <= len(x) <= 200 and "\n" not in x and "\t" not in x


def test_top_level_keys_and_sizes():
    assert set(S) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= S["run_seconds"] <= 51 and isinstance(S["run_seconds"], int)
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (S["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= len(S["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in S["paths"])
    assert 1 <= len(S["command"]) <= 32 and all(line(w) for w in S["command"])


def test_names_units_and_entries():
    names = []
    for c in S["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/") and (spec.ROOT / c["file"]).is_file()
        names.append(c["name"])
    used = set()
    for w in S["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4) and line(w["why"])
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        used.add(w["config"])
        names.append(w["name"])
    assert used == {c["name"] for c in S["configs"]}
    assert len({(w["config"], w["traffic"]) for w in S["workloads"]}) == len(S["workloads"])
    cells = {w["name"] for w in S["workloads"]}
    e2e = {m["name"] for m in S["end_to_end"]}
    assert "setup_s" in e2e
    for m in S["end_to_end"] + S["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= cells if "workloads" in m else True
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
        names.append(m["name"])
    for m in S["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in S["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert line(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert len(names) == len(set(names))


@pytest.mark.parametrize("entry", S["configs"], ids=lambda c: c["name"])
def test_configuration_files(entry):
    cfg = json.loads((spec.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    Params.from_config(cfg)
    for key in ("source", "assumed", "guarantees", "precision", "target_reads", "query_reads", "batch_size",
                "num_anchors", "window", "platform"):
        assert key in cfg


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer():
    for w in S["workloads"]:
        cell = spec.cell(S, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
            assert callable(spec.reader(m["name"]))
    assert (spec.HERE / "traffic" / "q20_mtb.json").is_file()
