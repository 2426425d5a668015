"""A tiny cell of each configuration for the CPU tests: the shipped
configuration files with a small corpus and engine shape."""

from __future__ import annotations

import json

from benchmark import spec

TINY_TRAFFIC = {
    "name": "tiny",
    "genome": {
        "size": 60_000,
        "gc": 0.6,
        "repeats": [{"families": 1, "length": 500, "copies": 4, "divergence": 0.0},
                    {"families": 2, "tandem": True, "unit": 60, "copies": 4, "divergence": 0.02}],
    },
    "reads": {"shape": 3.0, "mean": 900, "min": 500, "max": 2_000,
              "substitution": 0.012, "insertion": 0.006, "deletion": 0.012},
}
TINY_SHAPE = {"target_reads": 150, "query_reads": 48, "batch_size": 16, "num_anchors": 512}


def tiny_cell(config: str, monkeypatch=None) -> spec.Cell:
    """The configuration ``config`` at the tiny shape; with
    ``monkeypatch``, the engine's buckets set to match."""
    cfg = json.loads((spec.HERE / "configs" / f"{config}.json").read_text())
    cfg.update(TINY_SHAPE)
    if monkeypatch is not None:
        monkeypatch.setenv("LRGE_DEVICE_BUCKET", "2048")
        monkeypatch.setenv("LRGE_DEVICE_MIN_ROWS", "0")
    full = spec.load()
    return spec.Cell(f"tiny.{config}", 1, cfg, dict(TINY_TRAFFIC), spec._for(full["end_to_end"], "ont.r9_mtb"),
                     spec._for(full["per_layer"], "ont.r9_mtb"))
