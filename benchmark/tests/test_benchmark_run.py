"""A whole run of a tiny cell on the CPU (the look for a card skipped):
``correct`` holds for the program and fails for the control and for
each fault of ``benchmark/faults.py``; and the trace's reduction."""

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import faults, run, trace
from benchmark.tests.cells import tiny_cell


@pytest.mark.parametrize("config", ["ont_twoset", "pb_twoset"])
def test_tiny_cell_is_correct(config, monkeypatch):
    cell = tiny_cell(config, monkeypatch)
    result, notes = run.run_cell(cell, 2**31 + 7, 0.05, False, torch.device("cpu"), workers=2)
    assert result["correct"] is True
    assert list(result)[-1] == "checks" and list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert result["attempted"] >= cell.config["query_reads"] and result["failed"] == 0
    assert all(c["value"] == 0 for c in result["checks"].values())
    json.dumps(result)


@pytest.mark.parametrize("name", ["control_bf16", "zeros", "half", "altered"])
def test_control_and_faults_are_not_correct(name, monkeypatch):
    cell = tiny_cell("ont_twoset", monkeypatch)
    hook = faults.control_bf16 if name == "control_bf16" else faults.FAULTS[name]
    result, _ = run.run_cell(cell, 41, 0.01, False, torch.device("cpu"), workers=2, fault=hook)
    assert result["correct"] is False


def test_per_layer_metrics_of_a_run(monkeypatch):
    """Every per-layer metric that needs no trace reads a number."""
    cell = tiny_cell("ont_twoset", monkeypatch)
    cell.end_to_end = [m for m in cell.per_layer if m["source"] != "device_trace"]
    result, _ = run.run_cell(cell, 8, 0.01, False, torch.device("cpu"), workers=2)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert 0 < result["metrics"]["anchor_occupancy_pct"]["value"] <= 100


def ev(name, start, end, cuda=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def test_trace_reduce_takes_the_union_and_names_idle_gaps():
    events = [
        ev(trace.WINDOW_SPAN, 50, 950, cuda=True),  # its device-side annotation
        ev(trace.WINDOW_SPAN, 0, 1_000),
        ev("bench.count_batch", 0, 800),
        ev("bench.estimate", 800, 1_000),
        ev("bench.count_batch", 0, 800, cuda=True),  # the span's device-side annotation
        ev("k1", 100, 300, cuda=True),
        ev("void chain_dp_kernel<32, 0>", 200, 400, cuda=True),  # overlaps k1
        ev("k2", 780, 810, cuda=True),
        ev("k1", 900, 1_200, cuda=True),  # clipped at the window's end
    ]
    red = trace.reduce(SimpleNamespace(events=lambda: events))
    assert red["window_s"] == pytest.approx(1e-3)
    assert red["busy_s"] == pytest.approx(430e-6)
    assert red["kernels"]["k1"] == pytest.approx(300e-6)
    assert trace.chain_seconds(red) == pytest.approx(200e-6)
    # idle: 0-100 and 400-780 under count_batch, 810-900 under estimate
    assert red["idle"] == pytest.approx({"bench.count_batch": 480e-6, "bench.estimate": 90e-6})
    bd = trace.breakdown(red)
    assert bd["device_ops"][0][0] == "k1" and len(bd["idle_gaps"]) == 2


@pytest.mark.gpu
def test_tiny_cell_on_card_and_its_control():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = tiny_cell("ont_twoset")
    dev = torch.device("cuda", 0)
    result, _ = run.run_cell(cell, 3, 0.5, True, dev, workers=2)
    assert result["correct"] is True and result["device"]["busy_s"] > 0
    control, _ = run.run_cell(cell, 3, 0.2, False, dev, workers=2, fault=faults.control_bf16)
    assert control["correct"] is False
