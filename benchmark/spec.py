"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (its ``file``), its traffic mix
(``benchmark/traffic/<traffic>.json``) and each metric's reader
(``benchmark/metrics/<name>.py``, a ``read(record)`` function that
returns the metric's value, or None where it finds nothing to read)."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the metric entries this cell reports, by kind
    per_layer: list


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _for(metrics: list, cell: str) -> list:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``spec``; raises ``KeyError`` for an unknown name."""
    wl = {w["name"]: w for w in spec["workloads"]}[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())
    return Cell(name, wl["chips"], config, traffic, _for(spec["end_to_end"], name), _for(spec["per_layer"], name))


def reader(name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
