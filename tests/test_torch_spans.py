"""The port's spans and counters (``lrge_tpu_torch/spans.py``) on the CPU.

On the tiny corpus, in ONT on one sub-index, PacBio and an index sharded
in two: one ``count_batch`` is one pass record whose spans nest (each
child within its parent, every parent in the same record) under one
``count_batch`` span, the host thread's among them; ``last_phases``,
``last_host_s`` and a program's ``capture_s`` are their spans'
durations, to the bit; the super-batches dispatched are the bucket's
groups of batches, and their spans sum to no more than ``enqueue``; the
pass counters match the super-batches run.  The pass
history and a record's spans stay bounded (the newest kept), warm-up
calls and the set-up's builds land in the set-up record, a
``torch.profiler`` session sees the spans as ``lrge.*`` events, and with
no session recording ``record_function`` is never entered.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
from test_torch_knobs import BASE, corpus  # noqa: F401 (fixture)

from lrge_tpu_torch import spans
from lrge_tpu_torch.device_engine import STAGES, DeviceOverlapEngine
from lrge_tpu_torch.ops.index import build_index
from lrge_tpu_torch.ops.program import ProgramKey, SuperBatchProgram
from lrge_tpu_torch.platform import Platform, preset_for

CPU = torch.device("cpu")
# (knobs, preset, devices, the span each super-batch's host work must hold)
MODES = {
    # reads of 2-3 kb pass the last bucket: the host thread counts them
    "ont_one_sub": ({"LRGE_DEVICE_BUCKET": "2048"}, Platform.NANOPORE, CPU, "enqueue.pack"),
    "pacbio": ({}, Platform.PACBIO, CPU, "enqueue.pb_fill"),
    "sharded": ({"LRGE_SHARDS": "2"}, Platform.NANOPORE, [CPU] * 2, "enqueue.submit"),
}


def engine(corpus, monkeypatch, mode):  # noqa: F811
    knobs, platform, device, _ = MODES[mode]
    targets, tnames, _, _ = corpus
    for key, val in {**BASE, **knobs}.items():
        monkeypatch.setenv(key, val)
    index = build_index(targets, tnames, preset_for(platform, dual=True))
    dev = DeviceOverlapEngine(index, device=device)
    if mode == "ont_one_sub":
        assert dev.gdev.n_sub == 1
    if mode == "sharded":
        assert dev.sharded.n_shards == 2
    return dev


def by_name(rec, name):
    return [s for s in rec.spans if s.name == name]


@pytest.mark.parametrize("mode", list(MODES))
def test_pass_record_nests_and_its_views_are_its_spans(corpus, monkeypatch, mode):  # noqa: F811
    _, _, queries, qnames = corpus
    dev = engine(corpus, monkeypatch, mode)
    groups, batch_groups = {}, dev.batch_groups

    def record_groups(L, rows_b, seqs):
        groups[L] = batch_groups(L, rows_b, seqs)
        return groups[L]

    monkeypatch.setattr(dev, "batch_groups", record_groups)
    before = spans.passes[-1].number if spans.passes else 0
    dev.count_batch(qnames, queries)
    rec = spans.passes[-1]
    assert rec.number > before and groups
    # one top-level span; every other span within its parent, in this record
    (call,) = [s for s in rec.spans if s.parent is None]
    assert call.name == "count_batch" and rec.wall == call.duration
    members = {id(s) for s in rec.spans}
    for s in rec.spans:
        assert s.start <= s.end
        if s.parent is not None:
            assert id(s.parent) in members
            assert s.parent.start <= s.start and s.end <= s.parent.end
    stages = {s.name: s for s in rec.children(call) if s.name in STAGES}
    assert set(stages) == set(STAGES)
    # the views are the spans' durations, the very same floats
    phases = dev.last_phases
    for name, s in stages.items():
        assert phases[name] == s.duration
    assert {k for k in phases if k.startswith("collect_L")} == {
        f"collect_L{s.tags['L']}" for s in rec.children(stages["collect"])
    }
    host = [s for s in rec.spans if s.name == "host_thread"]
    assert dev.last_host_s == sum(s.duration for s in host)
    assert all(s.parent is call for s in host)
    if mode == "ont_one_sub":
        assert len(host) == 1 and dev.last_host_s > 0
    # enqueue holds each bucket's batching and its super-batches, one a
    # group of batches; each super-batch its padding, its stage span and
    # its submission; children sum to no more than their parent
    enqueue = stages["enqueue"]
    kids = rec.children(enqueue)
    sbs = [s for s in kids if s.name == "super_batch"]
    assert {s.name for s in kids} == {"enqueue.batch", "super_batch"}
    assert len(kids) - len(sbs) == len(groups)
    dispatched = sorted((s.tags["L"], s.tags["i"]) for s in sbs)
    assert dispatched == [(L, i) for L in sorted(groups) for i in range(len(groups[L]))]
    assert sum(s.duration for s in kids) <= enqueue.duration
    for sb in sbs:
        kids = rec.children(sb)
        names = {k.name for k in kids}
        assert {"enqueue.batch", "enqueue.submit", MODES[mode][3]} <= names
        assert sum(k.duration for k in kids) <= sb.duration
        assert rec.self_time(sb) == sb.duration - sum(k.duration for k in kids)
    if mode == "pacbio":
        assert len(by_name(rec, "enqueue.pb_sketch")) == len(sbs)
    if mode == "sharded":
        # the query program and each shard's, a super-batch
        assert len(by_name(rec, "enqueue.submit")) == 3 * len(sbs)
    assert {s.name for s in rec.children(stages["collect"])} == {"collect.wait", "collect.triage"}
    assert len(by_name(rec, "collect.wait")) == len(sbs)
    assert {s.name for s in rec.children(stages["retry"])} <= {"retry.recount", "retry.join"}
    # counters: super-batches run, their row slots and padding rows
    assert rec.counters["row_slots"] == sum(dev.bucket_shape(s.tags["L"])[1] for s in sbs) * dev.batch_size
    assert 0 <= rec.counters["pad_rows"] < rec.counters["row_slots"]
    assert not by_name(rec, "capture")  # every program was captured before the pass


def test_warmup_and_set_up_land_in_the_set_up_record(corpus, monkeypatch):  # noqa: F811
    _, _, queries, qnames = corpus

    def since(old):
        # the set-up record's spans added after ``old`` (kept alive, so no id is reused)
        ids = {id(s) for s in old}
        return [s for s in spans.setup.spans if id(s) not in ids]

    old = list(spans.setup.spans)
    dev = engine(corpus, monkeypatch, "ont_one_sub")
    made = since(old)
    assert {"index.sketch", "index.assemble", "planes.host", "planes.copy"} <= {s.name for s in made}
    assert by_name(spans.setup, "load")  # the native extension, at import
    count = len(spans.passes) and spans.passes[-1].number
    old = list(spans.setup.spans)
    dev.warmup([len(q) for q in queries])
    assert (len(spans.passes) and spans.passes[-1].number) == count
    warm = since(old)
    calls = [s for s in warm if s.name == "count_batch"]
    assert calls and all(s.parent is None for s in calls)
    # a warm-up call is still the engine's last call
    assert dev.last_phases["enqueue"] == [s for s in warm if s.name == "enqueue"][-1].duration
    old = list(spans.setup.spans)
    dev.count_batch(qnames[:4], queries[:4])
    assert spans.passes[-1].number > count and not since(old)


def test_capture_s_is_the_capture_span(monkeypatch):
    """A program on a card times its capture by its ``capture`` span, in
    the current record (here the set-up's), tagged with its key."""
    monkeypatch.setattr(SuperBatchProgram, "_capture", lambda self, pool: sum(range(10_000)))
    key = ProgramKey("ont", 2048, 2048, 2, 16)
    prog = SuperBatchProgram(key, None, [], torch.device("cuda", 0))
    cap = spans.setup.spans[-1]
    assert cap.name == "capture" and cap.tags == {"key": key}
    assert prog.capture_s == cap.duration > 0
    assert SuperBatchProgram(key, None, [], CPU).capture_s == 0.0


def test_history_and_records_are_bounded(corpus, monkeypatch):  # noqa: F811
    _, _, queries, qnames = corpus
    dev = engine(corpus, monkeypatch, "ont_one_sub")
    monkeypatch.setattr(spans, "passes", collections.deque(maxlen=3))
    for _ in range(5):
        dev.count_batch(qnames[:2], queries[:2])
    assert len(spans.passes) == 3
    numbers = [r.number for r in spans.passes]
    assert numbers == list(range(numbers[0], numbers[0] + 3))
    # a record keeps its newest spans: the pass's stages and its count_batch
    monkeypatch.setattr(spans, "MAX_SPANS", 4)
    dev.count_batch(qnames[:2], queries[:2])
    kept = spans.passes[-1].spans
    assert len(kept) == 4 and [s.name for s in kept][-2:] == ["retry", "count_batch"]
    assert dev.last_phases["retry"] == kept[-2].duration


def test_profiler_sees_the_spans(corpus, monkeypatch):  # noqa: F811
    from torch.profiler import ProfilerActivity, profile

    _, _, queries, qnames = corpus
    dev = engine(corpus, monkeypatch, "ont_one_sub")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dev.count_batch(qnames, queries)
    names = {e.name for e in prof.events()}
    want = {"count_batch", *STAGES, "super_batch", "enqueue.batch", "enqueue.pack", "enqueue.submit",
            "collect.wait", "collect.triage", "retry.recount", "retry.join"}
    assert {spans.PREFIX + n for n in want} <= names


def test_off_path_never_enters_record_function(corpus, monkeypatch):  # noqa: F811
    _, _, queries, qnames = corpus
    dev = engine(corpus, monkeypatch, "pacbio")

    def refuse(*args, **kw):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    res = dev.count_batch(qnames, queries)
    assert res.counts.shape == (len(queries),) and np.all(res.counts >= 0)
    assert by_name(spans.passes[-1], "enqueue.pb_sketch")


def test_carry_hands_the_record_and_parent_to_a_thread():
    from concurrent.futures import ThreadPoolExecutor

    def work():
        with spans.span("host_thread", rows=2):
            pass

    with spans.pass_record() as rec, spans.span("count_batch") as call, spans.span("prep"):
        with ThreadPoolExecutor(1) as pool:
            pool.submit(spans.carry(work, call)).result()
        spans.count("rows", 2)
        spans.count("rows")
    assert spans.passes[-1] is rec and rec.counters == {"rows": 3}
    (host,) = by_name(rec, "host_thread")
    assert host.parent is call and host.tags == {"rows": 2}
    assert [s.name for s in rec.children(call)] == ["host_thread", "prep"]
