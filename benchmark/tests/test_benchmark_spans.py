"""The per-layer metrics read from the program's spans and counters
(``benchmark/program_spans.py``): the tiny PacBio cell reads its host
sketch and fill; a history that does not line up with the harness's
passes, or a program without spans, reads as nothing; and
``idle_named_pct`` over a reduced trace."""

import collections
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import run, spec, trace
from benchmark.tests.cells import tiny_cell


def test_tiny_pacbio_cell_reads_its_span_metrics(monkeypatch):
    cell = tiny_cell("pb_twoset", monkeypatch)
    full = spec.load()
    cell.end_to_end = [m for m in spec._for(full["per_layer"], "pb.hifi_cel") if m["source"] != "device_trace"]
    result, notes = run.run_cell(cell, 2**31 + 11, 0.01, False, torch.device("cpu"), workers=2)
    got = result["metrics"]
    assert set(got) == {m["name"] for m in cell.end_to_end}
    assert got["pb_sketch_ms"]["value"] > 0 and got["pb_fill_ms"]["value"] > 0
    assert got["batch_ms"]["value"] > 0 and got["submit_ms"]["value"] > 0
    # the stages are parts of enqueue
    parts = sum(got[k]["value"] for k in ("batch_ms", "pb_sketch_ms", "pb_fill_ms", "submit_ms"))
    assert parts <= got["enqueue_ms"]["value"]
    assert 0 <= got["pad_rows_pct"]["value"] < 100
    assert got["index_sketch_s"]["value"] > 0 and got["planes_host_s"]["value"] > 0
    assert got["index_assemble_s"]["value"] > 0 and got["planes_copy_s"]["value"] > 0
    assert not [n for n in notes if "does not line up" in n]


def one_pass(enqueue_extra=0.0):
    """A pass record of the program with an ``enqueue`` span, and the
    harness's pass whose ``enqueue`` phase is its duration plus
    ``enqueue_extra``."""
    from lrge_tpu_torch import spans

    with spans.pass_record(), spans.span("count_batch"):
        with spans.span("enqueue") as enq, spans.span("enqueue.batch"):
            spans.count("row_slots", 8)
            spans.count("pad_rows", 2)
    phases = {"enqueue": enq.duration + enqueue_extra}
    return run.Pass(0.1, np.zeros(1), (0, 0, 0), 0, {}, phases, 0, 1)


def record(passes):
    rec = run.Record({}, 1, "cpu")
    rec.passes = passes
    return rec


def test_span_readers_hold_the_history_to_the_passes(monkeypatch):
    from lrge_tpu_torch import spans

    batch, pad = spec.reader("batch_ms"), spec.reader("pad_rows_pct")
    monkeypatch.setattr(spans, "passes", collections.deque(maxlen=16))
    rec = record([one_pass(), one_pass()])
    assert batch(rec) > 0 and pad(rec) == 25.0 and spec.reader("pack_ms")(rec) == 0.0
    # a pass whose enqueue is not its record's: nothing, and why
    rec = record([one_pass(), one_pass(1e-3)])
    assert batch(rec) is None and pad(rec) is None
    assert any("does not line up" in n for n in rec.notes)
    # more passes than records
    rec = record([one_pass()] * (len(spans.passes) + 1))
    assert batch(rec) is None and any("pass records for" in n for n in rec.notes)
    # a program without the spans module, as before it had one
    import lrge_tpu_torch

    monkeypatch.delattr(lrge_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "lrge_tpu_torch.spans", None)
    for name in ("batch_ms", "pad_rows_pct", "load_s", "index_sketch_s", "index_assemble_s", "planes_host_s",
                 "planes_copy_s"):
        rec = record([run.Pass(0.1, np.zeros(1), (0, 0, 0), 0, {}, {"enqueue": 0.1}, 0, 1)])
        assert spec.reader(name)(rec) is None and any("none to read" in n for n in rec.notes)


def ev(name, start, end, cuda=False, annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if cuda else DeviceType.CPU, is_user_annotation=annotation)


def test_idle_named_pct_of_a_reduced_trace():
    read = spec.reader("idle_named_pct")
    assert read(SimpleNamespace(trace=None)) is None
    # the spans that only enclose stages name nothing, the harness's or the program's
    idle = {"bench.count_batch": 1.0, "host": 0.5, "gaps under 1 us": 0.5, "lrge.enqueue.batch": 6.0,
            "aten::copy_": 2.0, "lrge.count_batch": 0.5, "lrge.super_batch": 0.5}
    assert read(SimpleNamespace(trace={"idle": idle})) == pytest.approx(800.0 / 11)
    # through trace.reduce: the program's spans inside the harness's name the gaps
    events = [
        ev(trace.WINDOW_SPAN, 0, 1_000),
        ev("bench.count_batch", 0, 960),
        ev("lrge.count_batch", 0, 900),
        ev("lrge.enqueue", 0, 400),
        ev("lrge.enqueue.batch", 0, 200),
        ev("lrge.collect.wait", 400, 900),
        ev("lrge.count_batch", 0, 900, cuda=True, annotation=True),  # its shadow on the device
        ev("k1", 100, 300, cuda=True),
        ev("k2", 450, 700, cuda=True),
        ev("k3", 900, 920, cuda=True),
        ev("k4", 960, 980, cuda=True),
    ]
    red = trace.reduce(SimpleNamespace(events=lambda: events))
    # idle 0-100 under the batching, 300-450 under enqueue alone, 700-900
    # under the wait, 920-960 under the harness's span alone, 980-1000
    # under the window's
    assert red["idle"] == pytest.approx({"lrge.enqueue.batch": 100e-6, "lrge.enqueue": 150e-6,
                                         "lrge.collect.wait": 200e-6, "bench.count_batch": 40e-6, "host": 20e-6})
    assert read(SimpleNamespace(trace=red)) == pytest.approx(100.0 * 300 / 510)
