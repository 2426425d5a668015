"""The device engine's per-pass record in the PyTorch port vs the JAX reference.

After one ``count_batch`` the port's ``last_anchors_valid`` (anchors
chained, ``min(n_anchors, A)`` over live rows) and ``last_anchor_slots``
(``SUP * B * A`` a super-batch) equal the JAX engine's
(lrge_tpu/device_engine.py:1160-1163) in six modes: single-sub ONT,
a multi-sub index (``LRGE_DEVICE_ANCHORS=1024``), ``-P pb``, an index
sharded in two (``LRGE_SHARDS=2``), pair collection and ``-F``.
``last_phases`` holds the reference's keys (``prep``, ``enqueue``,
``collect``, one ``collect_L{L}`` a bucket, ``retry``) with
non-negative seconds.  Integer outputs: tolerance 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny per-op work: intra-op threads only contend with the other workers
torch.set_num_threads(1)
from test_torch_knobs import BASE, corpus  # noqa: F401 (fixture)

from lrge_tpu.device_engine import DeviceOverlapEngine as RefEngine
from lrge_tpu.ops.index import build_index
from lrge_tpu.platform import Platform, preset_for
from lrge_tpu_torch.device_engine import DeviceOverlapEngine

CPU = torch.device("cpu")
# (knobs, preset, dual, count_batch keywords)
MODES = {
    "single_sub": ({}, Platform.NANOPORE, True, {}),
    "multi_sub": ({"LRGE_DEVICE_ANCHORS": "1024"}, Platform.NANOPORE, True, {}),
    "pacbio": ({}, Platform.PACBIO, True, {}),
    "sharded": ({"LRGE_SHARDS": "2"}, Platform.NANOPORE, True, {}),
    "pairs": ({}, Platform.NANOPORE, False, {"collect_pairs": True}),
    "filter": ({}, Platform.NANOPORE, True, {"filter_ratio": 0.2}),
}
STAGES = {"prep", "enqueue", "collect", "retry"}


def run(engine, qnames, queries, kw):
    kw = dict(kw, collect_pairs={} if kw.get("collect_pairs") else None)
    return engine.count_batch(qnames, queries, **kw)


@pytest.mark.parametrize("mode", list(MODES))
def test_record_equals_reference(corpus, monkeypatch, mode):
    knobs, platform, dual, kw = MODES[mode]
    targets, tnames, queries, qnames = corpus
    for key, val in {**BASE, **knobs}.items():
        monkeypatch.setenv(key, val)
    index = build_index(targets, tnames, preset_for(platform, dual=dual))
    refe = RefEngine(index)
    dev = DeviceOverlapEngine(index, device=[CPU] * 2 if mode == "sharded" else CPU)
    if mode == "multi_sub":
        assert dev.gdev.n_sub == refe.gdev.n_sub >= 2
    if mode == "sharded":
        assert dev.sharded.n_shards == refe.sharded.n_shards == 2
    if mode == "filter":
        assert dev.supports_device_filter() and refe.supports_device_filter()
    want = run(refe, qnames, queries, kw)
    got = run(dev, qnames, queries, kw)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert 0 < dev.last_anchors_valid <= dev.last_anchor_slots
    assert dev.last_anchors_valid == refe.last_anchors_valid
    assert dev.last_anchor_slots == refe.last_anchor_slots
    assert set(dev.last_phases) == set(refe.last_phases)
    assert STAGES < set(dev.last_phases) and all(v >= 0 for v in dev.last_phases.values())
    # one collect_L{L} a bucket that ran on the device
    assert {k for k in dev.last_phases if k.startswith("collect_L")} == {"collect_L4096"}


def test_record_resets_and_device_free_branch(corpus, monkeypatch):
    """A second call starts the tallies from 0; an engine without device
    planes (an empty index) resets them and leaves ``last_phases`` alone,
    as the reference's device-free branch does."""
    targets, tnames, queries, qnames = corpus
    for key, val in BASE.items():
        monkeypatch.setenv(key, val)
    index = build_index(targets, tnames, preset_for(Platform.NANOPORE, dual=True))
    dev = DeviceOverlapEngine(index, device=CPU)
    dev.count_batch(qnames, queries)
    first = (dev.last_anchors_valid, dev.last_anchor_slots)
    dev.count_batch(qnames[:10], queries[:10])
    # one super-batch each time: the same slots, fewer anchors
    assert dev.last_anchor_slots == first[1] and 0 < dev.last_anchors_valid < first[0]
    empty = build_index([b"ACGT"], [b"t0"], preset_for(Platform.NANOPORE, dual=True))
    ref_empty = RefEngine(empty)
    dev_empty = DeviceOverlapEngine(empty, device=CPU)
    assert not dev_empty.device_ok and not ref_empty.device_ok
    for e in (ref_empty, dev_empty):
        e.last_anchors_valid = e.last_anchor_slots = 7
        e.count_batch(qnames[:4], queries[:4])
        assert (e.last_anchors_valid, e.last_anchor_slots) == (0, 0)
        assert not hasattr(e, "last_phases")
